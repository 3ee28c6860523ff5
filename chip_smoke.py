#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--scans N]

Run from the root of a checkout. Phases, each fatal on failure:
  1. card: nvidia-smi name and power limit, torch's device name;
  2. build: the CUDA kernels of panovlm_tpu_torch/csrc, compiled from this
     checkout (ops/_build.py);
  3. kernel vs plain: each KNN kernel against its plain PyTorch version at
     the association shapes (B=256 pairs; point->line Q=T=1024, k=5;
     point->plane Q=512, T=4096, k=10 with ring offsets +-1, +-2), indices
     equal except on near-ties, d2 within rtol 1e-5 / atol 1e-5, timed with
     CUDA events (median of 10 after warm-up);
  4. the odometry stage (`python -m panovlm_tpu_torch init_lidar_pose`,
     in-process) on a synthetic Room-454 dataset (tests/synthetic.py, the
     loop trajectory of _room_scale.sh, 16 rings x 1800 azimuths),
     checked against ground truth (consecutive-scan distance error
     < 0.05 m in both pose files) and for kernel launches on that path.
Prints the kernel table as one JSON line, then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero without that line when there
is no CUDA device or a phase fails.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
NEAR_TIE = 1e-5


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


# ----------------------------------------------------------------------------
# phase 3: kernel vs plain
# ----------------------------------------------------------------------------

def _time_ms(fn, reps: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return (times[(reps - 1) // 2] + times[reps // 2]) / 2


def _check_slots(name, d, i, d_ref, i_ref, d2_full):
    """d2 within rtol/atol 1e-5; an index may differ from the plain one only
    on a near-tie: the plain distance of the kernel's pick is within
    1e-5 * max(1, d2) of the plain slot's distance."""
    import torch
    torch.testing.assert_close(d, d_ref, rtol=1e-5, atol=1e-5, msg=name)
    diff = i != i_ref
    n_ties = int(diff.sum())
    if n_ties:
        b, q, _ = torch.nonzero(diff, as_tuple=True)
        d_pick = d2_full[b, q, i[diff].long()]
        d_slot = d_ref[diff]
        tie = (d_pick - d_slot).abs() <= NEAR_TIE * torch.clamp_min(d_slot, 1.0)
        if not bool(tie.all()):
            fail(f"{name}: {int((~tie).sum())} index mismatches that are not near-ties")
    return float((d - d_ref).abs().max()), n_ties


def kernel_vs_plain(torch, knn_mod):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B = 256

    def cloud(n):
        return (torch.rand((B, n, 3), generator=g, device=dev) * 6.0 - 3.0).contiguous()

    def mask(n):
        return torch.rand((B, n), generator=g, device=dev) > 0.1

    rows = {}
    # K1 at the point->line shape
    q, t = cloud(1024), cloud(1024)
    qm, tm = mask(1024), mask(1024)
    d, i = knn_mod.knn(q, qm, t, tm, 5)
    d_ref, i_ref = knn_mod.knn_reference(q, qm, t, tm, 5)
    torch.cuda.synchronize()
    d2_full = knn_mod._dist2(q, qm, t, tm)
    err, ties = _check_slots("knn", d, i, d_ref, i_ref, d2_full)
    del d2_full
    rows["knn"] = dict(max_abs_err=err, near_ties=ties,
                       ms=_time_ms(lambda: knn_mod.knn(q, qm, t, tm, 5)),
                       plain_ms=_time_ms(lambda: knn_mod.knn_reference(q, qm, t, tm, 5)),
                       shape="B=256 Q=1024 T=1024 D=3 k=5")
    # K2 at the point->plane shape
    q, t = cloud(512), cloud(4096)
    qm, tm = mask(512), mask(4096)
    qr = torch.randint(0, 16, (B, 512), generator=g, device=dev, dtype=torch.int32)
    tr = torch.randint(0, 16, (B, 4096), generator=g, device=dev, dtype=torch.int32)
    out = knn_mod.knn_ring(q, qm, t, tm, qr, tr, 10)
    ref = knn_mod.knn_ring_reference(q, qm, t, tm, qr, tr, 10)
    torch.cuda.synchronize()
    d2_full = knn_mod._dist2(q, qm, t, tm)
    err1, t1 = _check_slots("knn_ring top-k", out[0], out[1], ref[0], ref[1], d2_full)
    err2, t2 = _check_slots("knn_ring rings", out[2], out[3], ref[2], ref[3], d2_full)
    del d2_full
    rows["knn_ring"] = dict(
        max_abs_err=max(err1, err2), near_ties=t1 + t2,
        ms=_time_ms(lambda: knn_mod.knn_ring(q, qm, t, tm, qr, tr, 10)),
        plain_ms=_time_ms(lambda: knn_mod.knn_ring_reference(q, qm, t, tm, qr, tr, 10)),
        shape="B=256 Q=512 T=4096 D=3 k=10 rings=4")
    for name, r in rows.items():
        log(f"kernel {name} [{r['shape']}]: max |d2 - plain| {r['max_abs_err']:.3g}, "
            f"near-tie index swaps {r['near_ties']}, kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms")
    return rows


# ----------------------------------------------------------------------------
# phase 4: the odometry stage on a synthetic Room dataset
# ----------------------------------------------------------------------------

ROOM_ODOMETRY_KEYS = """\
angle_residual               = true
point_to_line_residual       = false
line_to_line_residual        = true
point_to_plane_residual      = true
lidar_plane_tolerance        = 0.05
point_to_line_dis_threshold  = 0.3
point_to_plane_dis_threshold = 1.0
normalize_distance           = true
num_iteration_lidar          = 7
"""


def make_room(root: str, n: int, loop: int = 454, seed: int = 0):
    """The first n scans of the synthetic Room-`loop` trajectory, a
    perturbed (2 cm / 0.5 deg, scan 0 exact) stage-1 lidar_pose.txt and
    config.txt. Returns (config path, ground-truth lidar poses, mean points
    per scan)."""
    import numpy as np
    from scipy.spatial.transform import Rotation as ScR
    import synthetic
    from panovlm_tpu.io import artifacts
    from panovlm_tpu.io.pointcloud import write_pcd

    yaw = 2.5 * 2 * math.pi / loop       # _room_scale.sh: 2.5 loops of the room
    scans, poses = synthetic.make_trajectory_scans(
        n_scans=n, step=(0.8 * yaw, 0.0, 0.0), yaw_step=yaw, origin=(0.0, 0.0, -1.0),
        noise=0.002, h_steps=1800, sweep_alpha=0.5, body_step=True)
    os.makedirs(os.path.join(root, "lidar"))
    for i, scan in enumerate(scans):
        write_pcd(os.path.join(root, "lidar", f"{i:06d}.pcd"), scan,
                  intensity=np.zeros(len(scan), np.float32))
    S = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
    R = np.stack([S @ p[0] @ S.T for p in poses])
    t = np.stack([S @ p[1] for p in poses])
    rng = np.random.default_rng(seed)
    dR = ScR.from_rotvec(rng.normal(size=(n, 3)) * np.radians(0.5)).as_matrix()
    dt = rng.normal(size=(n, 3)) * 0.02
    dR[0], dt[0] = np.eye(3), 0.0
    os.makedirs(os.path.join(root, "result", "sfm"))
    artifacts.export_pose_t(os.path.join(root, "result", "sfm", "lidar_pose.txt"),
                            R @ dR, t + dt)
    cfg = os.path.join(root, "config.txt")
    with open(cfg, "w") as f:
        f.write(f"lidar_path = {root}/lidar\nresult_path = {root}/result\n"
                f"lidar_path_undistort = {root}/result/undis\n"
                f"data_gap_time = 0.1\n{ROOM_ODOMETRY_KEYS}")
    return cfg, poses, sum(len(s) for s in scans) / n


def run_stage(torch, knn_mod, n_scans: int):
    import numpy as np
    from panovlm_tpu.config import load_config
    from panovlm_tpu.io import artifacts
    from panovlm_tpu_torch.__main__ import main as port_main

    with tempfile.TemporaryDirectory(prefix="chip_smoke_room_") as root:
        t0 = time.time()
        cfg_path, gt, mean_pts = make_room(root, n_scans)
        log(f"dataset: Room-{n_scans} synthetic, {mean_pts:.0f} points/scan, "
            f"built in {time.time() - t0:.1f} s")
        infos = []
        torch.cuda.reset_peak_memory_stats()
        knn_mod.knn.launches = 0
        knn_mod.knn_ring.launches = 0
        t0 = time.time()
        rc = port_main(["init_lidar_pose", cfg_path, "--device", "cuda"], infos=infos)
        wall = time.time() - t0
        launches = {"knn": knn_mod.knn.launches, "knn_ring": knn_mod.knn_ring.launches}
        if rc != 0:
            fail(f"init_lidar_pose exited {rc}")
        log(f"stage wall {wall:.1f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for r, info in enumerate(infos):
            log(f"odometry round {r}: {info['pairs']} pairs, cost "
                f"{info['initial_cost']:.6g} -> {info['final_cost']:.6g}, "
                f"{info['iterations']} LM iterations")
        log(f"kernel launches on the main path: {launches}")
        if min(launches.values()) <= 0:
            fail(f"a kernel of the path was not launched: {launches}")

        cfg = load_config(cfg_path)
        for name in ("lidar_pose_refined.txt", "lidar_center_refined.pcd",
                     "lidar_pose_refined.ply", "lidar_pose_undis_refined.txt",
                     "lidar_center_undis_refined.pcd"):
            if not os.path.exists(os.path.join(cfg.odo_result_path, name)):
                fail(f"missing artifact {name}")
        n_und = len(os.listdir(cfg.lidar_path_undistort))
        if n_und != n_scans:
            fail(f"{n_und} undistorted clouds for {n_scans} scans")
        d_gt = np.linalg.norm(np.diff(np.stack([p[1] for p in gt]), axis=0), axis=1)
        for name in ("lidar_pose_refined.txt", "lidar_pose_undis_refined.txt"):
            _, t, _, ok = artifacts.read_pose_t(os.path.join(cfg.odo_result_path, name))
            if not ok.all():
                fail(f"{name}: invalid poses")
            err = np.abs(np.linalg.norm(np.diff(t, axis=0), axis=1) - d_gt)
            log(f"{name}: consecutive-scan distance error vs ground truth: "
                f"max {err.max() * 1000:.2f} mm, median {np.median(err) * 1000:.2f} mm")
            if not err.max() < 0.05:
                fail(f"{name}: error {err.max():.4f} m >= 0.05 m at scan {int(err.argmax())}")
    return launches


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=454)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "panovlm_tpu_torch")):
        fail("panovlm_tpu_torch/ not found: run from a checkout of the repository")
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]

    # 1. card
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")

    from panovlm_tpu_torch.device import resolve
    resolve("cuda")
    from panovlm_tpu_torch.ops import _build
    from panovlm_tpu_torch.ops import knn as knn_mod

    # 2. build
    t0 = time.time()
    lib_path = _build.build()
    _build.load()
    log(f"build: {lib_path.relative_to(HERE)} in {time.time() - t0:.1f} s "
        f"(nvcc {'ran' if _build.build_seconds is not None else 'not needed'})")

    # 3. kernel vs plain
    rows = kernel_vs_plain(torch, knn_mod)

    # 4. the stage
    launches = run_stage(torch, knn_mod, args.scans)

    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if leaked:
        fail(f"jax was imported: {leaked}")
    replaces = {"knn": "panovlm_tpu/ops/pallas/knn.py:30",
                "knn_ring": "panovlm_tpu/ops/pallas/knn.py:93"}
    log(card)   # as nvidia-smi prints it: name, power limit
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": "panovlm_tpu_torch/csrc/knn.cu",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in rows.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
