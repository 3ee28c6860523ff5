#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--scans N] [--mvs-frames N] [--sfm-frames N]
                          [--profile-mvs] [--only-sfm]

Run from the root of a checkout. Phases, each fatal on failure:
  1. card: nvidia-smi name and power limit, torch's device name; the MVS
     dataset's panoramas start rendering in worker processes meanwhile;
  2. build: the CUDA kernels of panovlm_tpu_torch/csrc, compiled from this
     checkout (ops/_build.py, one nvcc per source, in parallel); then the
     script waits for the renders (the MVS and the SfM panoramas) and stops
     the workers, so that every later phase runs on an otherwise idle host;
  3. kernel vs plain, timed with CUDA events (median of 10 after warm-up):
     - each KNN kernel at the association shapes on random clouds (B=256
       pairs, 90 % of the points valid; point->line Q=T=1024, k=5;
       point->plane Q=512, T=4096, k=10 with ring offsets +-1, +-2, the
       target ring ids sorted within each pair as the stage's are):
       indices equal except on near-ties, d2 within rtol/atol 1e-5, two
       launches bit-equal;
     - the plane-sweep NCC kernel at the Room MVS shapes, 720 x 1440: full
       scoring V=4 views, C=2 candidates, T=49 texels (7x7), D=64 slices;
       candidate ranking V=2, C=16, T=5, every 4th slice (D=16); both again
       at 723 x 1443 (partial 32 x 8 tiles at the right and bottom edges):
       max |kernel - plain| <= 2e-4, and two launches bit-equal;
  4. the odometry stage (`python -m panovlm_tpu_torch init_lidar_pose`,
     in-process) on a synthetic Room-454 dataset (tests/synthetic.py, the
     loop trajectory of _room_scale.sh, 16 rings x 1800 azimuths), checked
     against ground truth (consecutive-scan distance error < 0.05 m in both
     pose files) and for kernel launches on that path (one knn and one
     knn_ring launch per association round); the arguments of the first
     knn and knn_ring calls are kept on the card;
  5. K1 and K2 on those arguments (the first association round, B = its
     pair count, ~3,500): as in phase 3, with the plain version and the
     library call run in chunks of 256 pairs and timed as the sum over the
     chunks; prints the valid shares of queries, targets and pairs;
  6. the MVS stage (`python -m panovlm_tpu_torch joint_mvs`, in-process) on
     the first --mvs-frames frames of the same loop: 2880 x 5760 panoramas
     rendered by tests/synthetic.render_panorama, written as PNG, read at
     scale -2 (720 x 1440) with the Room MVS keys (configs/Room.txt:75-87;
     min_depth 0.1, the Config default, since Room's 0 divides by zero in
     the sweep path, ROADMAP F7), undistorted scans and ground-truth joint
     camera/LiDAR poses. Checked: the artifact set, the median relative
     depth error < 0.08 in rows H/4..3H/4 (the bound of
     tests/test_pipeline_cli_late.py), a floor on the share of that band
     with a depth, and K3 launches;
  7. K3 against its plain version at the shapes phase 6 launched it with:
     the sweep range and slice count that the stage's range fit chose (read
     from its log), full scoring at C=2, the initial scoring at C=1 and the
     ranking on every 4th slice, max |kernel - plain| <= 2e-4, two launches
     bit-equal;
  8. the SfM stage (`python -m panovlm_tpu_torch init_camera_pose`,
     in-process) on --sfm-frames frames of the same loop, every 6th (frames
     0, 6, ..., 282 by default: ~1.55 laps), panoramas rendered straight at
     the working size 720 x 1440 (scale 0), the scans of those frames with
     T_cl = identity, the Room SfM keys (configs/Room.txt:38-55) with
     frame_match_method 6, max_depth 5 and the on-device SIFT; checked: every
     frame valid, camera_pose_final.txt within 1 deg and 0.08 m of ground
     truth after aligning frame 0 (the bounds of
     tests/test_pipeline_cli.py::test_stage1_init_camera_pose), one launch of
     the fused descriptor search per batch of pairs; then the device SIFT
     and the VLAD proposal twice more on the same frames: descriptors,
     embeddings and pairs bit-equal to each other and to the stage's
     (ROADMAP F8);
  9. K1 at D = 128 (csrc/knn_desc.cu, `knn_mutual`: forward top-2 and
     reverse top-1 in one launch) against two plain searches on the stage's
     own descriptors: the first pairs it matched, at the batch the stage
     launches, Q = T = num_sift, and a ragged cut (Q = 5000, T = 7001, more
     rows masked); two launches bit-equal.
--only-sfm runs phases 1-2, 8 and 9 alone (for iterating on the SfM
slice). Prints the card line, the kernel table as one JSON line, then, as
the last line, {"ok": true, "device": {...}}. In the kernel table, the
headline numbers of knn and knn_ring are those at the odometry stage's
inputs (phase 5), volscore's those of the D=64 full-scoring shape of phase
3 and knn_desc's those of the fused search at the stage's batch; each
row's max_abs_err is the largest over its shapes, and its "shapes" list
holds each shape's numbers, with the bound of an earlier operation count
beside the current one (`bound_ms_pr3` for volscore and knn_desc;
`bound_ms_pr4` for knn and knn_ring, counting every point and every one
of the B*Q*T pairs, where their bound counts only the valid points'
coordinates and the valid pairs). Exits non-zero without that line
when there is no CUDA device or a phase fails. --profile-mvs wraps phase 6
in torch.profiler and writes its kernel table to chiprun_out/mvs_profile.txt.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import multiprocessing
import os
import struct
import subprocess
import sys
import tempfile
import time
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
NEAR_TIE = 1e-5
# Published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s,
# float32 operations/s outside the tensor cores, dense TF32 tensor-core
# operations/s.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
S = ((1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0))   # lidar z-up -> camera axes


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float):
    """Least time on the card: the larger of the bytes at HBM rate and the
    operations at the float32 rate. Returns (ms, "bytes" or "operations")."""
    t_b, t_o = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


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


def knn_valid_counts(q_mask, t_mask):
    """(valid queries, valid targets, valid pairs) over the batch; the
    pairs are the sum of |valid queries_b| x |valid targets_b|, whose
    distances the function needs (a masked pair's output, 1e30, is known
    without one), and only valid points' coordinates need to be read."""
    import torch
    nq, nt = q_mask.sum(1).double(), t_mask.sum(1).double()
    return int(nq.sum()), int(nt.sum()), int(torch.sum(nq * nt))


def _knn_bound(B, Q, T, D, k, ring, valid=None):
    """Bytes: both masks and the valid points' coordinates (+ ring ids) read
    once, (d2, idx) (+ ring outputs) written once for every query;
    operations: 3D+3 per valid (query, target) pair (|q|^2 + |t|^2 - 2 q.t
    and one top-k compare), one more for the ring minimum. `valid` is
    knn_valid_counts(); with None every point and every one of the B*Q*T
    pairs counts (the earlier count, kept as `bound_ms_pr4`)."""
    n_q, n_t, pairs = (B * Q, B * T, B * Q * T) if valid is None else valid
    n_out = k + (4 if ring else 0)
    n_bytes = (B * (Q + T) + (n_q + n_t) * (4 * D + (4 if ring else 0))
               + B * Q * n_out * 8)
    return bound_ms(n_bytes, pairs * (3 * D + 3 + (1 if ring else 0)))


KNN_CHUNK = 256   # pairs per plain-version and library call (phase 3's B)


def knn_case(torch, knn_mod, name, args, k, label):
    """K1 (args q, q_mask, t, t_mask) or K2 (args + q_row, t_row, ring
    offsets +-1, +-2) against its plain version: two launches bit-equal,
    d2 within rtol/atol 1e-5 and indices equal except on near-ties. The
    plain version and the library call (cdist + topk) run on chunks of
    KNN_CHUNK pairs (at the stage's batch they would need tens of GB at
    once); their times are the sums over the chunks. Returns the row."""
    ring = len(args) == 6
    q, qm, t, tm = args[:4]
    B, Q, D = q.shape
    T = t.shape[1]
    kernel = knn_mod.knn_ring if ring else knn_mod.knn
    plain = knn_mod.knn_ring_reference if ring else knn_mod.knn_reference
    out, again = kernel(*args, k), kernel(*args, k)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        fail(f"{name} [{label}]: two launches on the same inputs differ")
    del again
    chunks = [slice(b0, min(B, b0 + KNN_CHUNK)) for b0 in range(0, B, KNN_CHUNK)]
    errs, ties = [0.0], 0
    for sl in chunks:
        part = [a[sl] for a in args]
        ref = plain(*part, k)
        d2_full = knn_mod._dist2(*part[:4])
        for what, j in (("top-k", 0), ("rings", 2))[:2 if ring else 1]:
            e, n = _check_slots(f"{name} {what} [{label}]", out[j][sl], out[j + 1][sl],
                                ref[j], ref[j + 1], d2_full)
            errs.append(e)
            ties += n
        del ref, d2_full
    del out
    torch.cuda.empty_cache()
    valid = knn_valid_counts(qm, tm)
    pairs = valid[2]
    b_ms, b_by = _knn_bound(B, Q, T, D, k, ring, valid)
    b4_ms, _ = _knn_bound(B, Q, T, D, k, ring)
    row = dict(
        max_abs_err=max(errs), near_ties=ties,
        ms=_time_ms(lambda: kernel(*args, k)),
        plain_ms=sum(_time_ms(lambda: plain(*[a[sl] for a in args], k), reps=3)
                     for sl in chunks),
        library_ms=sum(_time_ms(lambda: torch.topk(torch.cdist(q[sl], t[sl]), k,
                                                    largest=False), reps=3)
                       for sl in chunks),
        bound_ms=b_ms, bound_by=b_by, bound_ms_pr4=b4_ms,
        valid_queries=float(qm.float().mean()), valid_targets=float(tm.float().mean()),
        valid_pairs=pairs / (B * Q * T),
        shape=f"B={B} Q={Q} T={T} D={D} k={k}{' rings=4' if ring else ''} ({label})")
    chunked = f" in {len(chunks)} chunks of {KNN_CHUNK} pairs" if len(chunks) > 1 else ""
    log(f"kernel {name} [{row['shape']}]: valid queries {row['valid_queries']:.4f}, "
        f"valid targets {row['valid_targets']:.4f}, valid pairs {row['valid_pairs']:.4f}; "
        f"max |d2 - plain| {row['max_abs_err']:.3g}, near-tie index swaps {ties}, repeat "
        f"bit-equal, kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms{chunked}, "
        f"cdist+topk {row['library_ms']:.3f} ms{chunked}, bound {b_ms:.4f} ms ({b_by}; "
        f"counting every point and pair {b4_ms:.4f} ms)")
    return row


def knn_vs_plain(torch, knn_mod):
    """Phase 3's KNN part: K1 and K2 at the association shapes, B = 256
    pairs of random clouds with 90 % of the points valid, interleaved; K2's
    target ring ids sorted within each pair, as gather_masked orders them."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    B = 256

    def cloud(n):
        return (torch.rand((B, n, 3), generator=g, device=dev) * 6.0 - 3.0).contiguous()

    def mask(n):
        return torch.rand((B, n), generator=g, device=dev) > 0.1

    rows = {"knn": knn_case(torch, knn_mod, "knn",
                            (cloud(1024), mask(1024), cloud(1024), mask(1024)), 5, "random")}
    q, t = cloud(512), cloud(4096)
    qm, tm = mask(512), mask(4096)
    qr = torch.randint(0, 16, (B, 512), generator=g, device=dev, dtype=torch.int32)
    tr = torch.randint(0, 16, (B, 4096), generator=g, device=dev,
                       dtype=torch.int32).sort(dim=1).values
    rows["knn_ring"] = knn_case(torch, knn_mod, "knn_ring", (q, qm, t, tm, qr, tr), 10,
                                "random")
    return rows


def knn_at_stage(torch, knn_mod, captured):
    """Phase 5: K1 and K2 on the arguments of their first launch in the
    odometry stage (the first association round, B = its pair count)."""
    rows = {}
    for name, nargs in (("knn", 4), ("knn_ring", 6)):
        args = captured[name]
        if name == "knn_ring" and tuple(args[7]) != knn_mod.RING_OFFSETS:
            fail(f"knn_ring was called with ring offsets {args[7]}")
        rows[name] = knn_case(torch, knn_mod, name, tuple(args[:nargs]), args[nargs],
                              "odometry stage, round 0")
    return rows


# K3 arithmetic (csrc/volscore.cu), each operation counted once at the
# level of the indices its value depends on:
#   (pixel, texel): the gray difference, its square, the scale, the exp (4);
#   (candidate, pixel, texel): the texel-ray dot (5), the denominator clamp
#     (2), lambda (1), max and reciprocal (2), the slice coordinate (2) and
#     its clip (2), floor, fraction and 1 - f (3), the weight gate (1),
#     w i_t (1), the three moments of the gray (4): 23;
#   (view, candidate, pixel, texel): the two-slice interpolation (3), w s
#     (1), the three moments with s (5): 9;
#   (candidate, pixel): the plane offset (6), the gray mean and variance
#     (5), the validity tests (3): 14;
#   (view, candidate, pixel): the rest of the NCC epilogue (15).
# The count of the PR 3 kernel, which repeated the lower levels per view and
# candidate, was 36 per (view, candidate, pixel, texel) and 21 per (view,
# candidate, pixel): VOLSCORE_OPS_PR3, kept to compare the two shares.
VOLSCORE_OPS = (("pixel texel", 4), ("candidate pixel texel", 23),
                ("view candidate pixel texel", 9), ("candidate pixel", 14),
                ("view candidate pixel", 15))
VOLSCORE_OPS_PR3 = (36, 21)


def volscore_ops(V, C, T, H, W):
    """Operations of one K3 launch, per level of VOLSCORE_OPS."""
    HW = H * W
    n = {"pixel texel": HW * T, "candidate pixel texel": C * HW * T,
         "view candidate pixel texel": V * C * HW * T, "candidate pixel": C * HW,
         "view candidate pixel": V * C * HW}
    return {level: n[level] * ops for level, ops in VOLSCORE_OPS}


def _volscore_bytes(V, D, C, H, W):
    """The volume (bf16), depth + normals, rays + gray read once; the
    (V, C) costs written once."""
    HW = H * W
    return V * D * HW * 2 + C * HW * 4 * 4 + HW * 4 * 4 + V * C * HW * 4


def _volscore_bound(V, D, C, T, H, W, pr3: bool = False):
    if pr3:
        per_texel, per_pixel = VOLSCORE_OPS_PR3
        n_ops = V * C * H * W * (T * per_texel + per_pixel)
    else:
        n_ops = sum(volscore_ops(V, C, T, H, W).values())
    return bound_ms(_volscore_bytes(V, D, C, H, W), n_ops)


def volscore_cases(pm, cfg, main_path: bool):
    """(label, views, candidates, texel offsets, slice stride) of K3's
    launches: full scoring (and, on the main path, the initial scoring of
    one candidate) over every slice and view, the ranking of 16 candidates
    on the sparse texels, the nearest views and every k-th slice."""
    full = pm._patch_offsets(cfg)
    cases = [("full", 4, 2, full, 1)]
    if main_path:
        cases.append(("init", 4, 1, full, 1))
    cases.append(("rank", cfg.prune_views, 16, pm._cheap_offsets(cfg),
                  cfg.prune_slice_stride))
    return cases


def volscore_vs_plain(torch, cfg, main_path: bool = False):
    """K3 against its plain version at 720 x 1440 (and, outside the main
    path, at 723 x 1443, whose rows and columns end in partial 32 x 8 tiles)
    and the sweep of cfg (cfg.sweep_slices slices over [cfg.min_depth,
    cfg.max_depth]), on inputs with the main path's layout and texture: a
    smooth reference gray and a (4, D, H, W) bf16 volume of shifted copies
    of it plus noise (on white-noise images the bilateral weights leave one
    or two effective texels, and NCC of a near-zero variance amplifies
    rounding), candidate depths inside the sweep range and normals facing
    the camera. Each shape runs the kernel twice: the two results must be
    equal bit for bit."""
    from panovlm_tpu_torch.ops import patchmatch as pm
    from panovlm_tpu_torch.ops import spherical
    from panovlm_tpu_torch.ops import volscore as vs

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    V, D = 4, cfg.sweep_slices
    lo, hi = max(cfg.min_depth, 1.0), min(cfg.max_depth, 4.0)
    rows = {}
    for H, W in ((720, 1440),) if main_path else ((720, 1440), (723, 1443)):
        rays = spherical.pixel_ray_grid(H, W, dev)
        rays_cf = rays.permute(2, 0, 1).contiguous()
        yy, xx = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                                torch.arange(W, device=dev, dtype=torch.float32),
                                indexing="ij")
        base = 0.5 + 0.25 * torch.sin(0.11 * xx + 0.07 * yy) * torch.cos(0.05 * yy)
        gray = base + 0.02 * torch.randn((H, W), generator=g, device=dev)
        vols = torch.stack([torch.stack([torch.roll(base, s + 3 * v, dims=1)
                                         for s in range(D)]) for v in range(V)])
        vols = (vols + 0.05 * torch.randn(vols.shape, generator=g, device=dev)
                ).to(torch.bfloat16)

        for label, nv, C, offsets, stride in volscore_cases(pm, cfg, main_path):
            label = f"main path {label}" if main_path else label
            if (H, W) != (720, 1440):
                label = f"{label} {H}x{W}"
            depth = lo + (hi - lo) * torch.rand((C, H, W), generator=g, device=dev)
            n_raw = -rays + 0.3 * torch.randn((C, H, W, 3), generator=g, device=dev)
            nrm = pm.random_normals(n_raw, rays).permute(0, 3, 1, 2).contiguous()
            sub = vols[:nv, ::stride]
            inv0, inv_step = pm._inv_grid(cfg, stride)
            args = (sub, depth, nrm, rays_cf, gray, offsets, inv0, inv_step,
                    cfg.min_depth, cfg.max_depth)
            out = vs.volscore(*args)
            again = vs.volscore(*args)
            ref = vs.volscore_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                fail(f"volscore [{label}]: two launches on the same inputs differ on "
                     f"{int((out != again).sum())} outputs")
            diff = (out - ref).abs()
            err = float(diff.max())
            if not err <= 2e-4:
                fail(f"volscore [{label}]: max |kernel - plain| {err:.3g} > 2e-4 on "
                     f"{int((diff > 2e-4).sum())} of {diff.numel()} outputs")
            shape = (nv, sub.shape[1], C, len(offsets), H, W)
            b_ms, b_by = _volscore_bound(*shape)
            b3_ms, _ = _volscore_bound(*shape, pr3=True)
            rows[label] = dict(
                max_abs_err=err, ms=_time_ms(lambda: vs.volscore(*args)),
                plain_ms=_time_ms(lambda: vs.volscore_reference(*args), reps=3),
                bound_ms=b_ms, bound_by=b_by, bound_ms_pr3=b3_ms,
                shape=(f"V={nv} C={C} T={len(offsets)} D={sub.shape[1]} {H}x{W} "
                       f"depths {cfg.min_depth:.4g}..{cfg.max_depth:.4g} m"))
            del out, again, ref, diff
            r = rows[label]
            log(f"kernel volscore {label} [{r['shape']}]: max |kernel - plain| {err:.3g}, "
                f"repeat bit-equal, kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}; PR 3 count {b3_ms:.4f} ms)")
        del vols
        torch.cuda.empty_cache()
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


def room_loop(n: int, loop: int = 454, sweep_alpha: float = 0.5):
    """The first n scans of the synthetic Room-`loop` trajectory (2.5 loops
    of the room, _room_scale.sh). Returns (scans, lidar poses)."""
    import synthetic
    yaw = 2.5 * 2 * math.pi / loop
    return synthetic.make_trajectory_scans(
        n_scans=n, step=(0.8 * yaw, 0.0, 0.0), yaw_step=yaw, origin=(0.0, 0.0, -1.0),
        noise=0.002, h_steps=1800, sweep_alpha=sweep_alpha, body_step=True)


def _camera_convention(poses):
    """Lidar z-up poses -> (R, t) in the camera-convention world."""
    import numpy as np
    Sm = np.asarray(S)
    return (np.stack([Sm @ p[0] @ Sm.T for p in poses]),
            np.stack([Sm @ p[1] for p in poses]))


def make_room(root: str, n: int, seed: int = 0):
    """The first n scans of the Room-454 loop, a perturbed (2 cm / 0.5 deg,
    scan 0 exact) stage-1 lidar_pose.txt and config.txt. Returns (config
    path, ground-truth lidar poses, mean points per scan)."""
    import numpy as np
    from scipy.spatial.transform import Rotation as ScR
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.io.pointcloud import write_pcd

    scans, poses = room_loop(n)
    os.makedirs(os.path.join(root, "lidar"))
    for i, scan in enumerate(scans):
        write_pcd(os.path.join(root, "lidar", f"{i:06d}.pcd"), scan,
                  intensity=np.zeros(len(scan), np.float32))
    R, t = _camera_convention(poses)
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


class _FirstCall:
    """Wraps the KNN functions that models/association.py imports and keeps
    a device copy of the arguments of each one's first call."""

    def __init__(self, module, names):
        self.module, self.names, self.args = module, names, {}

    def __enter__(self):
        self.saved = {n: getattr(self.module, n) for n in self.names}
        for name, fn in self.saved.items():
            def wrapped(*a, _name=name, _fn=fn):
                if _name not in self.args:
                    self.args[_name] = [x.clone() if hasattr(x, "clone") else x for x in a]
                return _fn(*a)
            setattr(self.module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.module, name, fn)


def run_odometry(torch, knn_mod, n_scans: int):
    """Phase 4. Returns (kernel launches, the arguments of the first knn and
    knn_ring calls)."""
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.models import association

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
        with _FirstCall(association, ("knn", "knn_ring")) as first:
            rc = port_main(["init_lidar_pose", cfg_path, "--device", "cuda"], infos=infos)
        wall = time.time() - t0
        launches = {"knn": knn_mod.knn.launches, "knn_ring": knn_mod.knn_ring.launches}
        if rc != 0:
            fail(f"init_lidar_pose exited {rc}")
        log(f"odometry stage wall {wall:.1f} s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        for r, info in enumerate(infos):
            log(f"odometry round {r}: {info['pairs']} pairs, cost "
                f"{info['initial_cost']:.6g} -> {info['final_cost']:.6g}, "
                f"{info['iterations']} LM iterations")
        log(f"kernel launches on the odometry path: {launches} in {len(infos)} "
            f"association rounds")
        if min(launches.values()) <= 0:
            fail(f"a kernel of the odometry path was not launched: {launches}")
        if set(launches.values()) != {len(infos)}:
            fail(f"launches {launches} differ from the {len(infos)} association rounds")
        if set(first.args) != {"knn", "knn_ring"}:
            fail(f"the stage's KNN calls were not captured: {sorted(first.args)}")

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
    return launches, first.args


# ----------------------------------------------------------------------------
# phase 6: the MVS stage on the same loop
# ----------------------------------------------------------------------------

ROOM_MVS_KEYS = """\
mvs_use_lidar        = true
scale                = -2
ncc_half_window      = 3
ncc_step             = 1
propagate_strategy   = 2
depth_diff_threshold = 0.01
min_segment          = 100
mvs_use_geometric    = true
keep_lidar_constant  = true
mvs_sweep_slices     = 64
max_depth            = 5
min_depth            = 0.1
"""
PANO_H, PANO_W = 2880, 5760   # Room panoramas; scale -2 works at 720 x 1440


def write_png_gray(path: str, img):
    """Minimal PNG encoder: 8-bit gray, filter type 0 on every row."""
    import numpy as np
    h, w = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), img], axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 1)))
        f.write(chunk(b"IEND", b""))


def _render_frame(args):
    """Worker: render frame i at panorama size into a PNG, and its
    ground-truth depth at the working size (returned)."""
    path, C, R_wc, pano_hw, work_hw = args
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import numpy as np
    import synthetic
    gray, _ = synthetic.render_panorama(C, *pano_hw, R_wc=R_wc)
    write_png_gray(path, np.clip(gray * 255, 0, 255).astype(np.uint8))
    return synthetic.render_panorama(C, *work_hw, R_wc=R_wc)[1]


def start_mvs_dataset(root: str, n: int, pool, pano_hw=(PANO_H, PANO_W)):
    """Write the scans, the joint poses and config.txt of the MVS dataset,
    and start rendering its panoramas (pano_hw) on `pool`. Returns (config
    path, async result of the ground-truth depths at the working size)."""
    import numpy as np
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.io.pointcloud import write_pcd

    scans, poses = room_loop(n, sweep_alpha=0.0)
    R, t = _camera_convention(poses)   # T_cl = identity: camera at the LiDAR
    for d in ("images", "undis", "result/joint"):
        os.makedirs(os.path.join(root, d))
    for i, scan in enumerate(scans):
        write_pcd(os.path.join(root, "undis", f"{i:06d}.pcd"), scan,
                  intensity=np.zeros(len(scan), np.float32))
    for name in ("camera_pose_joint.txt", "lidar_pose_joint.txt"):
        artifacts.export_pose_t(os.path.join(root, "result", "joint", name), R, t)
    cfg = os.path.join(root, "config.txt")
    with open(cfg, "w") as f:
        f.write(f"image_path = {root}/images\nlidar_path = {root}/undis\n"
                f"lidar_path_undistort = {root}/undis\nresult_path = {root}/result\n"
                f"mvs_data_path = {root}/mvs\n{ROOM_MVS_KEYS}")
    work = (pano_hw[0] // 4, pano_hw[1] // 4)      # scale -2
    jobs = [(os.path.join(root, "images", f"{i:06d}.png"), t[i], R[i], pano_hw, work)
            for i in range(n)]
    return cfg, pool.map_async(_render_frame, jobs)


# share of rows H/4..3H/4 that must hold a depth: about 80 % of what the
# H100 run measured (0.185 after post-processing, 0.120 filtered), so that a
# stage that drops most pixels cannot pass on the accuracy of the rest
MVS_MIN_COVERAGE = {"geo (post-processed)": 0.15, "filter": 0.095}


class _RangeFit(logging.Handler):
    """Keeps the arguments of the stage's "sweep range fit" log record:
    (min, max, fitted min, fitted max, slices, fitted slices)."""

    def __init__(self):
        super().__init__()
        self.args = None

    def emit(self, record):
        if str(record.msg).startswith("sweep range fit"):
            self.args = record.args


def run_mvs(torch, vs_mod, cfg_path, d_gt, profile: bool):
    """Phase 6. Returns (K3 launches, the PatchMatchConfig of the sweep the
    stage ran)."""
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.models import mvs
    from panovlm_tpu_torch.ops.patchmatch import PatchMatchConfig
    from panovlm_tpu_torch.utils.timing import TimeReport

    cfg = load_config(cfg_path)
    n = len(d_gt)
    tr = TimeReport()
    fit = _RangeFit()
    logging.getLogger("panovlm").addHandler(fit)
    torch.cuda.reset_peak_memory_stats()
    vs_mod.volscore.launches = 0
    t0 = time.time()
    try:
        if profile:
            from torch.profiler import ProfilerActivity, profile as tprofile
            with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                rc = port_main(["joint_mvs", cfg_path, "--device", "cuda"], tr=tr)
        else:
            rc = port_main(["joint_mvs", cfg_path, "--device", "cuda"], tr=tr)
    finally:
        logging.getLogger("panovlm").removeHandler(fit)
    wall = time.time() - t0
    launches = vs_mod.volscore.launches
    lo, hi, slices = cfg.min_depth, cfg.max_depth, cfg.mvs_sweep_slices
    if fit.args is not None:
        lo, hi, slices = fit.args[2], fit.args[3], fit.args[5]
    pm_run = PatchMatchConfig(ncc_half_window=cfg.ncc_half_window, ncc_step=cfg.ncc_step,
                              min_depth=float(lo), max_depth=float(hi),
                              sweep_slices=int(slices))
    log(f"MVS sweep: {pm_run.sweep_slices} slices over [{lo:.4f}, {hi:.4f}] m "
        f"({'range fit' if fit.args is not None else 'no range fit'})")
    if rc != 0:
        fail(f"joint_mvs exited {rc}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"MVS stage wall {wall:.1f} s, peak device memory {peak:.2f} GiB, "
        f"volscore launches {launches} ({launches / n:.1f} per frame)")
    for name in ("photometric pass", "geometric pass", "lidar depth init",
                 "post + filter", "fuse + export"):
        sec = tr.time_spent.get(name, float("nan"))
        log(f"  {name}: {sec:.2f} s ({sec / n:.3f} s per frame)")
    if launches <= 0:
        fail("the volscore kernel was not launched on the MVS path")
    if profile:
        write_profile(prof, wall)

    names = sorted(os.listdir(cfg.mvs_depth_path))
    want = sorted(f"{i:06d}_{s}.npy" for i in range(n) for s in ("pho", "geo", "filter"))
    if names != want:
        fail(f"depth artifacts {names[:6]}... != {want[:6]}...")
    for sub in (cfg.mvs_conf_path, cfg.mvs_normal_path):
        if len(os.listdir(sub)) != 2 * n:
            fail(f"{sub}: {len(os.listdir(sub))} files for {n} frames x 2 passes")
    if not os.path.exists(os.path.join(cfg.mvs_result_path, "mvs_fused.pcd")):
        fail("missing result/mvs/mvs_fused.pcd")
    errs = {"geo (post-processed)": [], "filter": []}
    for i in range(n):
        geo = torch.from_numpy(np.load(os.path.join(
            cfg.mvs_depth_path, f"{i:06d}_geo.npy")).astype(np.float32) / 256).cuda()
        geo = mvs.gap_interpolation(mvs.remove_small_segments(
            geo, cfg.depth_diff_threshold, cfg.min_segment)).cpu().numpy()
        filt = np.load(os.path.join(cfg.mvs_depth_path, f"{i:06d}_filter.npy")) / 256.0
        H, W = geo.shape
        band = np.zeros((H, W), bool)
        band[H // 4:3 * H // 4] = True
        for key, d in (("geo (post-processed)", geo), ("filter", filt)):
            have = band & (d > 0) & (d_gt[i] > 0)
            errs[key].append((np.abs(d - d_gt[i])[have] / d_gt[i][have], have.sum() / band.sum()))
    med = {}
    for key, parts in errs.items():
        med[key] = float(np.median(np.concatenate([e for e, _ in parts])))
        cover = float(np.mean([c for _, c in parts]))
        log(f"MVS depth vs ground truth [{key}]: median relative error {med[key]:.4f}, "
            f"coverage {cover:.3f} of rows H/4..3H/4")
        if not cover >= MVS_MIN_COVERAGE[key]:
            fail(f"MVS [{key}]: coverage {cover:.3f} < {MVS_MIN_COVERAGE[key]}")
    if not med["geo (post-processed)"] < 0.08:
        fail(f"MVS median relative depth error {med['geo (post-processed)']:.4f} >= 0.08")
    return launches, pm_run


# ----------------------------------------------------------------------------
# phases 8-9: the SfM stage on every 6th frame of the loop, then K1 at D = 128
# ----------------------------------------------------------------------------

ROOM_SFM_KEYS = """\
root_sift                    = true
num_sift                     = 8096
sift_match_dist_threshold    = 0.6
sift_match_num_threshold     = 40
keep_pairs_no_scale          = true
rotation_averaging_method    = 1
translation_averaging_method = 1
use_all_pairs_ra             = true
use_all_pairs_ta             = true
init_translation_DLT         = true
num_iteration_L2IRLS         = 3
upper_scale_ratio            = 1.3
lower_scale_ratio            = 1.0
triangulate_angle_threshold  = 25
colorize_structure           = true
frame_match_method           = 6
max_depth                    = 5
sift_device                  = true
scale                        = 0
"""
SFM_HW = (720, 1440)
SFM_EVERY = 6


def _render_sfm_frame(args):
    """Worker: render one panorama straight at the working size as PNG."""
    path, C, R_wc, hw = args
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    import numpy as np
    import synthetic
    gray, _ = synthetic.render_panorama(C, *hw, R_wc=R_wc)
    write_png_gray(path, np.clip(gray * 255, 0, 255).astype(np.uint8))


def start_sfm_dataset(root: str, n: int, pool, hw=SFM_HW, every: int = SFM_EVERY,
                      keys: str = ROOM_SFM_KEYS):
    """Frames 0, every, ..., every * (n - 1) of the Room-454 loop: their scans
    (sweep_alpha 0), config.txt, and the panorama renders started on `pool`.
    Returns (config path, async result of the renders, ground truth (R_wc,
    C) in the camera-convention world)."""
    import numpy as np
    from panovlm_tpu_torch.io.pointcloud import write_pcd
    scans, poses = room_loop(every * (n - 1) + 1, sweep_alpha=0.0)
    scans, poses = scans[::every], poses[::every]
    R, t = _camera_convention(poses)   # T_cl = identity: camera at the LiDAR
    for d in ("images", "lidar"):
        os.makedirs(os.path.join(root, d))
    for i, scan in enumerate(scans):
        write_pcd(os.path.join(root, "lidar", f"{i:06d}.pcd"), scan,
                  intensity=np.zeros(len(scan), np.float32))
    cfg = os.path.join(root, "config.txt")
    with open(cfg, "w") as f:
        f.write(f"image_path = {root}/images\nlidar_path = {root}/lidar\n"
                f"result_path = {root}/result\nframe_path = {root}/frames\n"
                f"match_pair_path = {root}/pairs\ndata_gap_time = 0.1\n"
                f"T_cl = 1 0 0 0 0 1 0 0 0 0 1 0\n{keys}")
    jobs = [(os.path.join(root, "images", f"{i:06d}.png"), t[i], R[i], hw) for i in range(n)]
    return cfg, pool.map_async(_render_sfm_frame, jobs), (R, t)


def sfm_pose_errors(path, gt):
    """(max rotation error deg, max camera-centre error m, all valid) of a
    pose file against ground truth, both aligned to frame 0."""
    import numpy as np
    from panovlm_tpu_torch.io import artifacts
    R_wc, t_wc, _, ok = artifacts.read_pose_t(path)
    R_gt, C_gt = gt
    R_al = np.einsum("ij,njk->nik", R_gt[0].T, R_gt)
    C_al = (C_gt - C_gt[0]) @ R_gt[0]
    rot = max(np.degrees(np.arccos(np.clip((np.trace(R_wc[i].T @ R_al[i]) - 1) / 2, -1, 1)))
              for i in range(len(R_wc)) if ok[i]) if ok.any() else float("inf")
    return rot, float(np.abs(t_wc[ok] - C_al[ok]).max()) if ok.any() else float("inf"), bool(ok.all())


def run_sfm(torch, knn_mod, cfg_path, gt):
    """Phase 8. Returns (K1-D128 launches, the stage's match batch, config)."""
    import numpy as np
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts
    from panovlm_tpu_torch.models import sfm
    from panovlm_tpu_torch.utils.timing import TimeReport

    cfg = load_config(cfg_path)
    tr = TimeReport()
    torch.cuda.reset_peak_memory_stats()
    knn_mod.knn_mutual.launches = 0
    knn_mod.knn.desc_launches = 0
    t0 = time.time()
    rc = port_main(["init_camera_pose", cfg_path, "--device", "cuda"], tr=tr)
    wall = time.time() - t0
    launches = knn_mod.knn_mutual.launches
    if rc != 0:
        fail(f"init_camera_pose exited {rc}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    batch = sfm.match_batch(torch.device("cuda"), int(cfg.num_sift))
    log(f"SfM stage wall {wall:.1f} s, peak device memory {peak:.2f} GiB, "
        f"descriptor KNN launches {launches} (mutual) + {knn_mod.knn.desc_launches} (knn)")
    for name, sec in tr.time_spent.items():
        if name != "init_camera_pose":
            log(f"  {name}: {sec:.2f} s")
    mp = artifacts.load_npz(os.path.join(cfg.match_pair_path, "match_pairs.npz"))
    pts = artifacts.load_npz(os.path.join(cfg.sfm_result_path, "points.npz"))
    with open(os.path.join(cfg.sfm_result_path, "match_pair.txt")) as f:
        n_rel = sum(1 for _ in f) // 3
    n = len(gt[0])
    P = len(mp["pi"])
    log(f"SfM counts: {n} frames, {P} pairs proposed, {int(mp['pair_ok'].sum())} pairs "
        f"with >= {cfg.sift_match_num_threshold} matches, {n_rel} pairs with a relative "
        f"pose, {len(pts['points'])} tracks ({int(pts['point_ok'].sum())} kept), "
        f"matching {tr.time_spent.get('match pairs', 0) / max(P, 1) * 1e3:.2f} ms per pair, "
        f"relative poses {tr.time_spent.get('relative poses', 0) / max(P, 1) * 1e3:.2f} ms per pair")
    if launches != -(-P // batch):
        fail(f"{launches} launches of the fused descriptor search for {P} pairs in "
             f"batches of {batch}: the SfM path did not match one launch per batch")
    rot, dist, all_ok = sfm_pose_errors(
        os.path.join(cfg.sfm_result_path, "camera_pose_final.txt"), gt)
    log(f"camera_pose_final.txt vs ground truth: max rotation error {rot:.4f} deg, "
        f"max camera-centre error {dist * 1000:.2f} mm, every frame valid: {all_ok}")
    if not all_ok:
        fail("init_camera_pose left frames invalid")
    if not (rot < 1.0 and dist < 0.08):
        fail(f"SfM poses off ground truth: {rot:.3f} deg, {dist:.4f} m (bounds 1 deg, 0.08 m)")
    return launches, batch, cfg


def sfm_reproducibility(torch, cfg):
    """ROADMAP F8: the device SIFT and the VLAD proposal run twice more on
    the stage's frames; the descriptors, the embeddings and the proposed
    pairs must equal each other and the stage's own bit for bit. As a
    control, the float scatter_add_ that the SIFT histograms used before
    runs twice on the same inputs at the descriptor-bin shape."""
    import numpy as np
    from panovlm_tpu_torch.io import artifacts, images
    from panovlm_tpu_torch.models import sfm, vlad
    from panovlm_tpu_torch.ops import sift_device as sd

    dev = torch.device("cuda")
    grays, _ = images.load_images(cfg.image_path, cfg.scale)
    H, W = grays[0].shape
    cap = int(cfg.num_sift)
    stage_desc = artifacts.load_npz(os.path.join(cfg.frame_path, "frames_sift.npz"))["desc"]
    mp = artifacts.load_npz(os.path.join(cfg.match_pair_path, "match_pairs.npz"))
    scfg = sfm.SfMConfig(num_sift=cap)
    runs = []
    t0 = time.time()
    for _ in range(2):
        uv, desc, fmask = sd.extract_sift_device_batch(
            np.stack(grays), num_features=cap, root_sift=cfg.root_sift,
            mask=images.load_mask(cfg.mask_path, H, W), device=dev)
        d, m = torch.as_tensor(desc, device=dev), torch.as_tensor(fmask, device=dev)
        _, _, emb = vlad.vlad_pairs(d, m, n_centers=min(64, cap))
        pi, pj = sfm.init_image_pairs(len(grays), scfg, embeddings=emb,
                                      methods=cfg.frame_match_method)
        runs.append(dict(uv=uv, desc=desc, fmask=fmask, emb=emb, pi=pi, pj=pj))
    differ = [k for k in runs[0] if not np.array_equal(runs[0][k], runs[1][k])]
    if not np.array_equal(runs[0]["desc"], stage_desc):
        differ.append("desc vs the stage's")
    if not (np.array_equal(runs[0]["pi"], mp["pi"]) and np.array_equal(runs[0]["pj"], mp["pj"])):
        differ.append("pairs vs the stage's")
    g = torch.Generator(device=dev).manual_seed(3)
    idx = torch.randint(0, 128, (8, cap, 256), generator=g, device=dev)
    src = torch.rand((8, cap, 256), generator=g, device=dev)
    a = torch.zeros((8, cap, 128), device=dev).scatter_add_(2, idx, src)
    b = torch.zeros((8, cap, 128), device=dev).scatter_add_(2, idx, src)
    control = float((a != b).double().mean())
    log(f"F8 reproducibility: device SIFT + VLAD twice more on {len(grays)} frames "
        f"({time.time() - t0:.1f} s): {len(runs[0]['pi'])} pairs, "
        f"{'differ: ' + ', '.join(differ) if differ else 'bit-equal to each other and to the stage'}; "
        f"control: float scatter_add_ at (8, {cap}, 256) -> 128 bins differs between two "
        f"runs on {control:.4%} of the bins")
    if differ:
        fail(f"F8: SfM inputs not reproducible: {differ}")
    return control


# K1 at D = 128, the fused search (csrc/knn_desc.cu, one launch per batch):
# per (query, target) pair D products, each three TF32 tensor-core
# multiply-adds (3xTF32: 6 operations) at the dense TF32 rate; at the fp32
# rate the epilogue, 6 per pair (|q|^2 + |t|^2, -2 q.t, clamp, mask test,
# the forward top-k compare, the reverse minimum), and the norms, 2D per
# row. The PR 3 count, two launches of D fp32 FMAs + 6 per pair at the
# fp32 rate, is kept as `pr3` to compare the two shares.
KNN_DESC_EPILOGUE_OPS = 6
KNN_DESC_OPS_PER_PAIR_PR3 = lambda D: 2 * D + 6


def knn_mutual_work(B, Q, T, D):
    """(bytes, tensor-core operations, fp32 operations) of one fused launch:
    descriptors and masks read once, the forward (d2, idx) top-2 and the
    reverse 8-byte keys written once."""
    n_bytes = B * (Q + T) * (4 * D + 1) + B * Q * 2 * 8 + B * T * 8
    return n_bytes, B * Q * T * D * 6, B * Q * T * KNN_DESC_EPILOGUE_OPS + B * (Q + T) * 2 * D


def knn_mutual_bound(B, Q, T, D, pr3: bool = False):
    """Least time of the fused search: the larger of the bytes at HBM rate
    and the operations (tensor-core part at the TF32 rate plus the fp32
    part at the fp32 rate); with pr3, the bound of the two fp32 launches
    it replaced."""
    n_bytes, tc_ops, f32_ops = knn_mutual_work(B, Q, T, D)
    if pr3:
        return bound_ms(n_bytes, 2 * B * Q * T * KNN_DESC_OPS_PER_PAIR_PR3(D))
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = (tc_ops / TF32_OPS_PER_S + f32_ops / F32_OPS_PER_S) * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def knn_mutual_vs_plain(torch, knn_mod, cfg, B):
    """Phase 9: K1 at D = 128, the fused forward top-2 + reverse top-1, on
    the stage's first B proposed pairs (Q = T = num_sift) and on a ragged
    cut of them (Q = 5000, T = 7001 with a fifth of the rows masked more),
    against two plain searches; every launch twice, bit-equal."""
    from panovlm_tpu_torch.io import artifacts
    fr = artifacts.load_npz(os.path.join(cfg.frame_path, "frames_sift.npz"))
    mp = artifacts.load_npz(os.path.join(cfg.match_pair_path, "match_pairs.npz"))
    dev = torch.device("cuda")
    desc = torch.as_tensor(fr["desc"], device=dev)
    fmask = torch.as_tensor(fr["fmask"], device=dev)
    pi = torch.as_tensor(mp["pi"][:B].astype("int64"), device=dev)
    pj = torch.as_tensor(mp["pj"][:B].astype("int64"), device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    full = (desc[pi], fmask[pi], desc[pj], fmask[pj])
    Qr, Tr = min(5000, desc.shape[1]), min(7001, desc.shape[1])
    ragged = (full[0][:, :Qr].contiguous(),
              full[1][:, :Qr] & (torch.rand((len(pi), Qr), generator=g, device=dev) > 0.2),
              full[2][:, :Tr].contiguous(),
              full[3][:, :Tr] & (torch.rand((len(pi), Tr), generator=g, device=dev) > 0.2))
    rows = {}
    for label, (q, qm, t, tm) in (("mutual", full), ("ragged", ragged)):
        Bq, Q, D = q.shape
        T = t.shape[1]
        out = knn_mod.knn_mutual(q, qm, t, tm)
        again = knn_mod.knn_mutual(q, qm, t, tm)
        ref = knn_mod.knn_mutual_reference(q, qm, t, tm)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            fail(f"knn_mutual [{label}]: two launches on the same inputs differ")
        d2_full = knn_mod._dist2(q, qm, t, tm)
        err_f, ties_f = _check_slots(f"knn_mutual {label} forward", out[0], out[1],
                                     ref[0], ref[1], d2_full)
        err_r, ties_r = _check_slots(f"knn_mutual {label} reverse", out[2], out[3],
                                     ref[2], ref[3], d2_full.transpose(1, 2))
        del d2_full, out, again, ref

        def library():
            dd = torch.cdist(q, t)
            return torch.topk(dd, 2, largest=False), torch.min(dd, dim=1)
        b_ms, b_by = knn_mutual_bound(Bq, Q, T, D)
        b3_ms, _ = knn_mutual_bound(Bq, Q, T, D, pr3=True)
        rows[label] = dict(
            max_abs_err=max(err_f, err_r), near_ties=ties_f + ties_r,
            ms=_time_ms(lambda: knn_mod.knn_mutual(q, qm, t, tm)),
            plain_ms=_time_ms(lambda: knn_mod.knn_mutual_reference(q, qm, t, tm), reps=3),
            library_ms=_time_ms(library, reps=3),
            bound_ms=b_ms, bound_by=b_by, bound_ms_pr3=b3_ms,
            shape=f"B={Bq} Q={Q} T={T} D={D} k=2 + reverse k=1")
        r = rows[label]
        log(f"kernel knn_desc {label} [{r['shape']}]: max |d2 - plain| {r['max_abs_err']:.3g}, "
            f"near-tie index swaps {ties_f} forward + {ties_r} reverse, repeat bit-equal, "
            f"kernel {r['ms']:.3f} ms, plain (two searches) {r['plain_ms']:.3f} ms, "
            f"cdist+topk+min {r['library_ms']:.3f} ms, bound {b_ms:.4f} ms ({b_by}; "
            f"PR 3 fp32 two-launch bound {b3_ms:.4f} ms)")
        torch.cuda.empty_cache()
    return rows


def write_profile(prof, wall):
    ka = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ka
                 if e.device_type is not None and "cuda" in str(e.device_type).lower())
    table = ka.table(sort_by="self_device_time_total", row_limit=30)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "mvs_profile.txt"), "w") as f:
        f.write(f"wall {wall:.3f} s, device self time {dev_us / 1e6:.3f} s\n{table}\n")
    log(f"MVS profile: wall {wall:.2f} s (profiling on), device self time "
        f"{dev_us / 1e6:.2f} s; table in chiprun_out/mvs_profile.txt")
    log(table)


def with_shapes(main, parts, **extra):
    """A kernel's row of the JSON line: the headline shape's numbers, the
    largest error over its shapes and each shape's numbers."""
    return dict(main, max_abs_err=max(r["max_abs_err"] for r in parts), **extra,
                shapes=[{"shape": r["shape"], **{k: r[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "bound_ms_pr3", "bound_ms_pr4") if k in r}}
                    for r in parts])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=454)
    ap.add_argument("--mvs-frames", type=int, default=16)
    ap.add_argument("--sfm-frames", type=int, default=48)
    ap.add_argument("--profile-mvs", action="store_true")
    ap.add_argument("--only-sfm", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "panovlm_tpu_torch")):
        fail("panovlm_tpu_torch/ not found: run from a checkout of the repository")
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    t_start = time.time()

    # 1. card; the MVS panoramas render on the host until phase 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, device "
        f"{torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    mvs_root = tempfile.TemporaryDirectory(prefix="chip_smoke_mvs_")
    sfm_root = tempfile.TemporaryDirectory(prefix="chip_smoke_sfm_")
    # three cores stay free for the three nvcc processes of the build
    pool = multiprocessing.get_context("spawn").Pool(max(1, (os.cpu_count() or 4) - 3))
    try:
        if not args.only_sfm:
            mvs_cfg, gt_async = start_mvs_dataset(mvs_root.name, args.mvs_frames, pool)
        sfm_cfg, sfm_async, sfm_gt = start_sfm_dataset(sfm_root.name, args.sfm_frames, pool)

        from panovlm_tpu_torch.device import resolve
        resolve("cuda")
        from panovlm_tpu_torch.ops import _build
        from panovlm_tpu_torch.ops import knn as knn_mod
        from panovlm_tpu_torch.ops import volscore as vs_mod
        from panovlm_tpu_torch.ops.patchmatch import PatchMatchConfig

        # 2. build
        t0 = time.time()
        lib_path = _build.build()
        _build.load()
        log(f"build: {lib_path.relative_to(HERE)} in {time.time() - t0:.1f} s "
            f"(nvcc {'ran' if _build.build_seconds is not None else 'not needed'})")
        regs = {}
        for line in _build.build_log.splitlines():   # ptxas: entry, then its properties
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
                kernel = next(k for k in ("volscore", "knn_desc", "knn") if k in line)
            elif "Used" in line and "registers" in line:
                regs.setdefault(kernel, []).append(int(line.split("Used")[1].split()[0]))
            elif "spill stores" in line and not line.strip().startswith("0 bytes stack frame, 0 bytes spill"):
                log(f"  spills in {entry}: {line.strip()}")
        for kernel, r in regs.items():
            log(f"  {kernel}: {len(r)} instantiation(s), {min(r)}-{max(r)} registers per thread")

        t0 = time.time()
        sfm_async.get(timeout=900)
        if not args.only_sfm:
            d_gt = gt_async.get(timeout=900)
            log(f"MVS dataset: {len(d_gt)} panoramas at 4x {d_gt[0].shape}")
        pool.close()
        pool.join()
        log(f"SfM dataset: {args.sfm_frames} panoramas at {SFM_HW}; renders ready "
            f"{time.time() - t0:.1f} s after the build")

        rows, launches = {}, {}
        if not args.only_sfm:
            # 3. kernel vs plain
            rows = knn_vs_plain(torch, knn_mod)
            vrows = volscore_vs_plain(torch, PatchMatchConfig(
                ncc_half_window=3, ncc_step=1, min_depth=0.5, max_depth=5.0,
                sweep_slices=64))

            # 4. the odometry stage
            launches, captured = run_odometry(torch, knn_mod, args.scans)

            # 5. K1 and K2 on the stage's own inputs
            t0 = time.time()
            for name, row in knn_at_stage(torch, knn_mod, captured).items():
                rows[name] = with_shapes(row, [rows[name], row])
            del captured
            torch.cuda.empty_cache()
            log(f"phase 5 (K1 and K2 at the stage's inputs): {time.time() - t0:.1f} s")

            # 6. the MVS stage
            launches["volscore"], pm_run = run_mvs(torch, vs_mod, mvs_cfg, d_gt,
                                                   args.profile_mvs)

            # 7. K3 at the shapes of phase 6
            vrows.update(volscore_vs_plain(torch, pm_run, main_path=True))
            rows["volscore"] = with_shapes(vrows["full"], list(vrows.values()),
                                           library_ms=None)

        # 8. the SfM stage, then its reproducibility (F8)
        launches["knn_desc"], match_batch, sfm_config = run_sfm(torch, knn_mod, sfm_cfg,
                                                                sfm_gt)
        sfm_reproducibility(torch, sfm_config)

        # 9. K1 at D = 128 on the stage's descriptors
        drows = knn_mutual_vs_plain(torch, knn_mod, sfm_config, match_batch)
        rows["knn_desc"] = with_shapes(drows["mutual"], list(drows.values()))
    finally:
        pool.terminate()
        pool.join()
        mvs_root.cleanup()
        sfm_root.cleanup()

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "panovlm_tpu"))
    if leaked:
        fail(f"jax or the JAX package was imported: {leaked}")
    log(f"whole script {time.time() - t_start:.1f} s")

    src = {"knn": "csrc/knn.cu", "knn_ring": "csrc/knn.cu", "volscore": "csrc/volscore.cu",
           "knn_desc": "csrc/knn_desc.cu"}
    replaces = {"knn": "panovlm_tpu/ops/pallas/knn.py:30",
                "knn_ring": "panovlm_tpu/ops/pallas/knn.py:93",
                "volscore": "panovlm_tpu/ops/pallas/volscore.py:40",
                "knn_desc": "panovlm_tpu/ops/pallas/knn.py:30"}
    log(card)   # as nvidia-smi prints it: name, power limit
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"panovlm_tpu_torch/{src[name]}",
         "replaces": replaces[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"], **({"shapes": r["shapes"]} if "shapes" in r else {})}
        for name, r in rows.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
