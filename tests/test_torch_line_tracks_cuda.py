"""The line-track modes and the calibration on the card against the CPU
(marked `cuda`: they skip where torch.cuda.is_available() is false). No
jax, cv2 or conftest fixtures, so they run on the machine with the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_line_tracks_cuda.py

  * the LBD descriptors of a rendered panorama's arcs within 1e-4 of the
    CPU's (float32 transcendentals differ by ulps, amplified as in
    tests/test_torch_line_tracks.py), lbd_distance_matrix between two
    frames' descriptors within 1e-5;
  * joint_optimize with the three line-track modes on a small line scene
    (the LiDAR lines' directions filled in, so that LiDAR line tracks form):
    the track-gate counts equal the CPU's, the poses within 2e-4;
  * perturb_calibration_search: the same pair count and T within 1e-5;
    calibrate: T within 1e-4;
  * each a second time on the card with the same bits.
"""

import os
import sys

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as ScR

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

torch.set_num_threads(2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from panovlm_tpu_torch.device import resolve
    return resolve("cuda")


def _lines(rng, n):
    """World segments 1-2.5 m long whose midpoints lie over 1.5 m out."""
    starts = rng.uniform(-3, 3, (n, 3))
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    ends = starts + dirs * rng.uniform(1, 2.5, (n, 1))
    far = np.linalg.norm(0.5 * (starts + ends), axis=1) > 1.5
    return starts[far].astype(np.float32), ends[far].astype(np.float32)


def _arcs(starts, ends, pose, cap=32):
    R = ScR.from_rotvec(pose[:3]).as_matrix()
    e1, e2 = starts @ R.T + pose[3:], ends @ R.T + pose[3:]
    e1 /= np.linalg.norm(e1, axis=1, keepdims=True)
    e2 /= np.linalg.norm(e2, axis=1, keepdims=True)
    n = np.cross(e1, e2)
    mid = e1 + e2
    out = {"normal": n / np.linalg.norm(n, axis=1, keepdims=True), "e1": e1, "e2": e2,
           "mid": mid / np.linalg.norm(mid, axis=1, keepdims=True),
           "arc": np.arccos(np.clip((e1 * e2).sum(1), -1, 1))}
    L = len(starts)
    pad = {k: np.zeros((cap,) + v.shape[1:], np.float32) for k, v in out.items()}
    for k, v in out.items():
        pad[k][:L] = v
    pad["mask"] = np.arange(cap) < L
    return pad


def _feats(starts, ends, pose, rng, per_line, P=128, Ls=16, noise=0.003):
    R = ScR.from_rotvec(pose[:3]).as_matrix()
    s = np.linspace(0.05, 0.95, per_line)[:, None]
    pts = np.concatenate([(a * (1 - s) + b * s) @ R.T + pose[3:] for a, b in zip(starts, ends)])
    pts += rng.normal(size=pts.shape) * noise
    n = min(len(pts), P)
    f = {"less_sharp": np.zeros((P, 3), np.float32), "less_sharp_mask": np.arange(P) < n,
         "point_to_segment": np.full(P, -1, np.int32),
         "line_endpoints": np.zeros((Ls, 2, 3), np.float32),
         "line_mask": np.arange(Ls) < len(starts)}
    f["less_sharp"][:n] = pts[:n]
    f["point_to_segment"][:n] = np.repeat(np.arange(len(starts)), per_line)[:n]
    f["line_endpoints"][:len(starts), 0] = starts @ R.T + pose[3:]
    f["line_endpoints"][:len(starts), 1] = ends @ R.T + pose[3:]
    return f


def _joint_scene(rng):
    """Three cameras and scans 0.2 m apart on 8 world lines (16 points
    each), the LiDAR lines' points and directions filled in, 60 tracked
    points, LiDAR poses perturbed."""
    starts, ends = _lines(rng, 8)
    cam = np.zeros((3, 6), np.float32)
    cam[:, 3] = np.arange(3) * 0.2
    lid_gt = cam.copy()
    lid_gt[:, 3] += 0.05
    arcs = [_arcs(starts, ends, c) for c in cam]
    feats = [_feats(starts, ends, p, rng, 16) for p in lid_gt]
    ab = {k: np.stack([a[k] for a in arcs]) for k in arcs[0]}
    lb = {k: np.stack([f[k] for f in feats]) for k in feats[0]}
    ends_l = lb["line_endpoints"]
    d = ends_l[:, :, 1] - ends_l[:, :, 0]
    nd = np.linalg.norm(d, axis=-1, keepdims=True)
    lb["line_points"] = (0.5 * (ends_l[:, :, 0] + ends_l[:, :, 1])).astype(np.float32)
    lb["line_dirs"] = np.where(nd > 0, d / np.maximum(nd, 1e-12), 0).astype(np.float32)
    for k, shape, dt in [("flat", (3, 64, 3), np.float32), ("flat_mask", (3, 64), bool),
                         ("flat_ground", (3, 64), bool), ("flat_row", (3, 64), np.int32),
                         ("less_flat", (3, 128, 3), np.float32),
                         ("less_flat_mask", (3, 128), bool),
                         ("less_flat_ground", (3, 128), bool),
                         ("less_flat_row", (3, 128), np.int32),
                         ("less_sharp_row", (3, 128), np.int32),
                         ("sharp", (3, 16, 3), np.float32), ("sharp_mask", (3, 16), bool)]:
        lb[k] = np.zeros(shape, dt)
    pts3d = rng.uniform(-3, 3, (60, 3)).astype(np.float32)
    pts3d[np.linalg.norm(pts3d, axis=1) < 1.0] += 2.0
    bearings = np.stack([(pts3d + c[3:]) / np.linalg.norm(pts3d + c[3:], axis=1, keepdims=True)
                         for c in cam]).astype(np.float32)
    lid0 = lid_gt.copy()
    lid0[:, :3] += rng.normal(size=(3, 3)).astype(np.float32) * 0.01
    lid0[:, 3:] += rng.normal(size=(3, 3)).astype(np.float32) * 0.03
    return ab, lb, (cam, lid0, np.tile(np.arange(3), (60, 1)).astype(np.int32),
                    np.tile(np.arange(60)[:, None], (1, 3)).astype(np.int32),
                    np.ones((60, 3), bool), bearings, pts3d, np.ones(60, bool))


@pytest.mark.cuda
def test_lbd_on_the_card_matches_the_cpu(cuda_device):
    from panovlm_tpu_torch.ops import lbd
    from panovlm_tpu_torch.utils import panorama_line as pl
    from synthetic import render_panorama

    def frame(x):
        g = np.clip(render_panorama(np.array([x, 0.4, 0.0]), 256, 512)[0], 0, 1)
        u8 = (g * 255).astype(np.uint8)
        arcs = pl.extract_panorama_lines(u8, cap=64)
        assert arcs["mask"].sum() > 10
        return [u8.astype(np.float32) / 255.0, arcs["e1"], arcs["e2"], arcs["mask"]]

    def run(args, dev):
        return lbd.line_band_descriptors(*[torch.as_tensor(a, device=dev) for a in args])
    a, b = frame(0.0), frame(0.05)
    cpu, gpu = run(a, "cpu"), run(a, cuda_device)
    assert torch.equal(gpu, run(a, cuda_device))
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), atol=1e-4, rtol=0)
    # distances between two frames' descriptors, as the matching takes them
    # (a descriptor against itself is a cancelled d2 under a sqrt)
    other = run(b, "cpu")
    d_cpu = lbd.lbd_distance_matrix(cpu, other)
    d_gpu = lbd.lbd_distance_matrix(cpu.to(cuda_device), other.to(cuda_device))
    np.testing.assert_allclose(d_gpu.cpu().numpy(), d_cpu.numpy(), atol=1e-5, rtol=0)
    assert torch.equal(d_gpu, lbd.lbd_distance_matrix(cpu.to(cuda_device),
                                                      other.to(cuda_device)))


@pytest.mark.cuda
def test_joint_track_modes_on_the_card_match_the_cpu(cuda_device):
    from panovlm_tpu_torch.models import camera_lidar as cl
    ab, lb, args = _joint_scene(np.random.default_rng(0))
    cfg = cl.JointConfig(num_iteration_joint=1, lidar_weight=0.01, camera_lidar_weight=5.0,
                         max_lm_iters=5, use_image_track=True, use_lidar_track=True,
                         use_track_associate=True)

    def run(dev):
        return cl.joint_optimize({k: torch.as_tensor(v, device=dev) for k, v in ab.items()},
                                 {k: torch.as_tensor(v, device=dev) for k, v in lb.items()},
                                 *args, cfg)
    cam_c, lid_c, _, info_c = run("cpu")
    cam_g, lid_g, pts_g, info_g = run(cuda_device)
    for k in ("image_lines", "image_lines_tracked", "lidar_lines", "lidar_lines_tracked",
              "line_pairs_untracked", "line_pairs_tracked"):
        assert info_g[0][k] == info_c[0][k], k
    assert info_c[0]["lidar_lines_tracked"] > 0 and info_c[0]["line_pairs_tracked"] > 0
    np.testing.assert_allclose(lid_g.cpu().numpy(), lid_c.numpy(), atol=2e-4, rtol=0)
    np.testing.assert_allclose(cam_g.cpu().numpy(), cam_c.numpy(), atol=2e-4, rtol=0)
    cam_2, lid_2, pts_2, _ = run(cuda_device)
    assert torch.equal(cam_2, cam_g) and torch.equal(lid_2, lid_g) and torch.equal(pts_2, pts_g)


@pytest.mark.cuda
def test_calibration_on_the_card_matches_the_cpu(cuda_device):
    from panovlm_tpu_torch.models import camera_lidar as cl
    rng = np.random.default_rng(0)
    starts, ends = _lines(rng, 14)
    pose = np.zeros(6, np.float32)
    arcs, feats = _arcs(starts, ends, pose), _feats(starts, ends, pose, rng, 14, P=256)
    T0 = np.eye(4)
    T0[:3, :3] = ScR.from_euler("xyz", [1.2, -0.9, 0.7], degrees=True).as_matrix()
    T0[:3, 3] = [0.06, -0.04, 0.05]
    T_c, n_c = cl.perturb_calibration_search(arcs, feats, T0, max_iterations=8, device="cpu")
    T_g, n_g = cl.perturb_calibration_search(arcs, feats, T0, max_iterations=8,
                                             device=cuda_device)
    assert n_g == n_c and n_c > 0
    np.testing.assert_allclose(T_g, T_c, atol=1e-5, rtol=0)
    assert np.array_equal(cl.perturb_calibration_search(arcs, feats, T0, max_iterations=8,
                                                        device=cuda_device)[0], T_g)
    C_c, _ = cl.calibrate(arcs, feats, T_g, device="cpu")
    C_g, _ = cl.calibrate(arcs, feats, T_g, device=cuda_device)
    np.testing.assert_allclose(C_g, C_c, atol=1e-4, rtol=0)
    assert np.array_equal(cl.calibrate(arcs, feats, T_g, device=cuda_device)[0], C_g)
