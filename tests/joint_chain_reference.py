"""The joint solve of chip_smoke.py's phase 10 (or 13), rerun on the CPU by
the JAX package and by the port, from the arguments and the card's result
that the phase keeps in chiprun_out/joint_chain.npz (or
joint_chain_tracks.npz):

    python tests/joint_chain_reference.py [chiprun_out/joint_chain.npz]
    python tests/joint_chain_reference.py chiprun_out/joint_chain_tracks.npz [--no-port]

panovlm_tpu.models.camera_lidar.joint_optimize runs on 8 CPU devices, on
the sharded path that the JAX stage takes there (its single-device solve
hits F1 at this size), and the port's joint_optimize runs on the CPU. Both
get the same arguments: the port's image arcs, LiDAR features, SfM and
odometry outputs. Prints, for the input LiDAR poses and for each result
(JAX on the CPU, the port on the CPU, the port on the card), the
consecutive-scan distance error against ground truth scan by scan, its
maximum, median and worst scan, the camera pose errors after aligning
frame 0, and how far the port's LiDAR centres lie from the JAX ones.

Phase 13's file also holds the arcs' LBD descriptors (computed on the
card), the frames as uint8 and the track flags in the config: both solves
get the descriptors and the frames as float [0, 1] (u8 / 255, as the
stages load them), so that the image-line matches are LBD-ranked and
LK-filtered (cv2's in the JAX package, native/lk.cpp in the port). It also
holds phase 13 (b)'s calibration pair: the JAX perturb_calibration_search
and calibrate run on it from the same start, and their errors against the
true T_cl (identity) are printed beside the card's. --no-port skips the
port's CPU joint solve.
"""

import json
import os
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from panovlm_tpu.models import camera_lidar as jcl  # noqa: E402
from panovlm_tpu.pipeline import _data_mesh  # noqa: E402
from panovlm_tpu_torch.models import camera_lidar as tcl  # noqa: E402
from panovlm_tpu_torch.utils import poses as pose_util  # noqa: E402

ARRAYS = ("cam_poses0", "lidar_poses0", "track_img", "track_feat", "track_mask",
          "bearings", "points0", "point_ok")


def centres(params):
    return pose_util.params_to_world(np.asarray(params, np.float64))


def camera_errors(params, R_gt, C_gt):
    """(max rotation error deg, max centre error m) after aligning frame 0."""
    R, C = centres(params)
    R_al = np.einsum("ij,njk->nik", R_gt[0].T, R_gt)
    C_al = (C_gt - C_gt[0]) @ R_gt[0]
    cos = (np.einsum("nij,nij->n", R, R_al) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(cos, -1, 1))).max()), float(np.abs(C - C_al).max())


def calibration(z, arcs, feats):
    """Phase 13 (b) with the JAX functions: errors against the identity."""
    from scipy.spatial.transform import Rotation as ScR
    f = int(z["calib_frame"])
    a1 = {k: jnp.asarray(v[f]) for k, v in arcs.items() if k in tcl._ARCS}
    f1 = {k: jnp.asarray(v[f]) for k, v in feats.items() if k in tcl._FEATS}

    def errors(T):
        rot = np.degrees(np.linalg.norm(ScR.from_matrix(T[:3, :3]).as_rotvec()))
        return f"rotation {rot:.4f} deg, translation {np.linalg.norm(T[:3, 3]) * 1000:.2f} mm"
    t0 = time.time()
    T_s, n_best = jcl.perturb_calibration_search(a1, f1, z["calib_T0"], max_iterations=8)
    T_c, info = jcl.calibrate(a1, f1, T_s)
    print(f"calibration pair {f} ({time.time() - t0:.1f} s): start {errors(z['calib_T0'])}")
    print(f"  JAX search: {n_best} pairs, {errors(T_s)}; calibrate: {errors(T_c)}")
    print(f"  card search: {int(z['calib_n_search'])} pairs, {errors(z['calib_T_search'])}; "
          f"calibrate: {errors(z['calib_T'])}")


def main(path, port=True):
    z = np.load(path)
    cfg = json.loads(str(z["jcfg"]))
    arcs = {k[4:]: z[k] for k in z.files if k.startswith("arc_")}
    feats = {k[6:]: z[k] for k in z.files if k.startswith("lidar_") and k != "lidar_valid"
             and k != "lidar_poses0"}
    args = [z[n] for n in ARRAYS]
    # phase 13: the frames as the stages load them
    grays = ([g.astype(np.float32) / 255.0 for g in z["grays_u8"]] if "grays_u8" in z.files
             else None)
    if "calib_frame" in z.files:
        calibration(z, arcs, feats)
    R_gt, C_gt = z["gt_R"], z["gt_C"]
    d_gt = np.linalg.norm(np.diff(C_gt, axis=0), axis=1)
    torch.set_num_threads(8)

    results = {"input": (z["cam_poses0"], z["lidar_poses0"])}
    t0 = time.time()
    cam, lidar, _, _ = jcl.joint_optimize(
        {k: jnp.asarray(v) for k, v in arcs.items()}, {k: jnp.asarray(v) for k, v in feats.items()},
        *args, jcl.JointConfig(**cfg), lidar_valid=z["lidar_valid"], grays=grays,
        mesh=_data_mesh())
    results["jax_cpu"] = (np.asarray(cam), np.asarray(lidar))
    print(f"JAX joint_optimize on the CPU ({len(jax.devices())} devices): {time.time() - t0:.1f} s")
    if port:
        t0 = time.time()
        cam, lidar, _, infos = tcl.joint_optimize(
            {k: torch.from_numpy(v) for k, v in arcs.items()},
            {k: torch.from_numpy(v) for k, v in feats.items()},
            *args, tcl.JointConfig(**cfg), lidar_valid=z["lidar_valid"], grays=grays)
        results["port_cpu"] = (cam.numpy(), lidar.numpy())
        print(f"port joint_optimize on the CPU: {time.time() - t0:.1f} s; rounds: "
              f"{[{k: v for k, v in i.items() if 'lines' in k or 'pairs' in k} for i in infos]}")
    results["port_card"] = (z["out_cam"], z["out_lidar"])

    errs = {}
    for name, (cam, lidar) in results.items():
        _, t = centres(lidar)
        errs[name] = np.linalg.norm(np.diff(t, axis=0), axis=1) - d_gt
    names = list(results)
    print("consecutive-scan distance error (mm), scan i -> i+1:")
    print("   i " + "".join(f"{n:>11}" for n in names))
    for i in range(len(d_gt)):
        print(f"{i:4d} " + "".join(f"{errs[n][i] * 1000:11.2f}" for n in names))
    for n in names:
        e = np.abs(errs[n])
        rot, dist = camera_errors(results[n][0], R_gt, C_gt)
        print(f"{n}: LiDAR max {e.max() * 1000:.2f} mm at scan {int(e.argmax())}, median "
              f"{np.median(e) * 1000:.2f} mm; camera max {rot:.4f} deg, {dist * 1000:.2f} mm")
    _, t_jax = centres(results["jax_cpu"][1])
    for n in [k for k in ("port_cpu", "port_card") if k in results]:
        _, t = centres(results[n][1])
        gap = np.linalg.norm(t - t_jax, axis=1)
        print(f"{n} vs jax_cpu: LiDAR centres differ by max {gap.max() * 1000:.2f} mm "
              f"(scan {int(gap.argmax())}), median {np.median(gap) * 1000:.2f} mm")


if __name__ == "__main__":
    paths = [a for a in sys.argv[1:] if not a.startswith("--")]
    main(paths[0] if paths else
         os.path.join(os.path.dirname(HERE), "chiprun_out", "joint_chain.npz"),
         port="--no-port" not in sys.argv)
