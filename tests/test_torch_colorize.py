"""Stage 4 of the port (models/texture.py, pipeline.colorize_lidar_map)
against the JAX package on the CPU.

  * texture.colorize_lidar_map on seeded inputs (12 scans x 600 points,
    5 cameras at 40 x 80, uint8 RGB panoramas; the JAX side gets them as
    float32 u8 / 255, as its load_images returns them): the nearest-camera
    choice equal to the cam_idx / cam_near the JAX function hands to its
    _colorize_all, ok equal. Points within 8e-6 m: the world transform
    R^T (p - t) rounds at the magnitude of its terms, and the scans reach
    40 m (measured 5.7e-6 there, 1.2e-6 within 6 m). Colours within 3e-5:
    XLA's and PyTorch's atan2 differ in the last bits, so u and v differ
    by an ulp or two (the spherical parity test allows 2e-5 px), and the
    random panoramas change by up to 1.0 per pixel (measured 1.33e-5; 80 %
    of the colours within 1e-6). The scans hold points on both sides of the
    seam (u wraps), points nearer than 0.1 m to the camera and farther than
    35 m; one scan has no camera within 1.5 m and one is invalid (masked
    out).
  * fuse_cloud against the JAX one on a coloured cloud of 20,000 points,
    2,000 of them on voxel boundaries (k * 0.04 in float32): the voxel keys
    of the points (floor(p / 0.04)) are the same except for points within
    float rounding of a boundary, where XLA's p * (1 / 0.04) and the port's
    division round apart (counted: some, at most the 2,000, each within
    1e-5 of an integer in p / 0.04); on the voxels whose members agree,
    centroids within 1e-6 m and colours within 1e-6 (the port's voxel sums
    are exact, the JAX ones float32 in their order; measured 1.2e-7 and
    6e-8 on a cloud without boundary points).
  * the stage against the JAX stage on a 4-frame synthetic.make_dataset
    (h_steps 900, 128 x 256) seeded with ground-truth joint pose files,
    its panoramas re-encoded as colour JPEG by cv2 (4:2:0, quality 95), so
    that both packages decode JPEG: the same fused voxel count, the fused
    points within 1e-6 m, the pcds' RGB equal except where the float
    colour times 255 lies within 1e-4 of an integer (the u8 export
    truncates there).
  * the port of tests/test_pipeline_cli_late.py::test_stage4_colorize on
    that dataset: more than 5000 fused points, and the pcd with RGB.
"""

import glob
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panovlm_tpu import pipeline as jpipe
from panovlm_tpu.config import load_config as jload_config
from panovlm_tpu.io import artifacts
from panovlm_tpu.models import texture as jtex
from panovlm_tpu_torch import pipeline as tpipe
from panovlm_tpu_torch.config import load_config as tload_config
from panovlm_tpu_torch.models import texture as ttex
from panovlm_tpu_torch.ops import se3 as tse3

from synthetic import make_dataset, seed_sfm_state

torch.set_num_threads(2)

S = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])


def _pose_params(R_wx, C):
    """[aa_xw, t_xw] of the world -> sensor transform of a sensor at C."""
    R_xw = np.transpose(R_wx, (0, 2, 1))
    aa = np.stack([tse3.log_so3(torch.from_numpy(R)).numpy() for R in R_xw])
    return np.concatenate([aa, -np.einsum("nij,nj->ni", R_xw, C)], axis=1).astype(np.float32)


def _rot(rng, n, deg):
    w = rng.normal(size=(n, 3)) * np.radians(deg)
    return tse3.exp_so3(torch.from_numpy(w)).numpy()


def _scene(seed=0, N=12, P=600, M=5, H=40, W=80):
    """Scans (N,P,3) local, masks, LiDAR and camera poses, u8 images."""
    rng = np.random.default_rng(seed)
    C_c = np.stack([np.linspace(-2, 2, M), rng.uniform(-0.2, 0.2, M),
                    rng.uniform(-0.3, 0.3, M)], axis=1)
    R_wc = _rot(rng, M, 20)
    cams = rng.integers(0, M, N)
    C_l = C_c[cams] + rng.normal(size=(N, 3)) * 0.3
    C_l[3] = (0.0, 5.0, 0.0)                             # no camera within 1.5 m
    R_wl = _rot(rng, N, 30)
    dirs = rng.normal(size=(N, P, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    r = rng.uniform(0.5, 6.0, (N, P, 1))
    r[:, 10:20] = 40.0                                    # farther than 35 m
    p_w = C_l[:, None] + dirs * r
    for i in range(N):
        j = int(np.argmin(np.linalg.norm(C_c - C_l[i], axis=1)))
        p_w[i, :10] = C_c[j] + dirs[i, :10] * 0.05        # nearer than 0.1 m to it
        # around its seam: behind it, x within +-2 mm
        d_c = np.stack([rng.uniform(-2e-3, 2e-3, 60), rng.uniform(-0.5, 0.5, 60),
                        -np.ones(60)], axis=1) * rng.uniform(1, 4, (60, 1))
        p_w[i, 20:80] = C_c[j] + d_c @ R_wc[j].T
    pts = np.einsum("nji,npj->npi", R_wl, p_w - C_l[:, None]).astype(np.float32)
    mask = rng.random((N, P)) < 0.95
    mask[5] = False                                       # an invalid scan
    images = rng.integers(0, 256, (M, H, W, 3)).astype(np.uint8)
    return pts, mask, _pose_params(R_wl, C_l), images, _pose_params(R_wc, C_c)


def test_colorize_lidar_map_matches_jax(monkeypatch):
    pts, mask, lp, images, cp = _scene()
    seen = {}
    colorize_all = jtex._colorize_all

    def spy(*args):
        seen["cam_idx"], seen["cam_near"] = np.asarray(args[5]), np.asarray(args[6])
        return colorize_all(*args)

    monkeypatch.setattr(jtex, "_colorize_all", spy)
    ref = [np.asarray(x) for x in jtex.colorize_lidar_map(
        pts, mask, lp, images.astype(np.float32) / 255.0, cp)]
    cam_idx, cam_near = ttex.nearest_cameras(lp, cp)
    np.testing.assert_array_equal(cam_idx, seen["cam_idx"])
    np.testing.assert_array_equal(cam_near, seen["cam_near"])
    assert not cam_near[3] and cam_near.sum() >= 8
    out = [t.numpy() for t in ttex.colorize_lidar_map(pts, mask, lp, images, cp,
                                                      device="cpu")]
    np.testing.assert_array_equal(out[2], ref[2])
    ok = ref[2].reshape(12, -1)
    assert ok[3].sum() == 0 and ok[5].sum() == 0 and ok[:, 10:20].sum() == 0
    assert ok[:, :10].sum() == 0 and ok[:, 20:80].sum() > 300    # the seam points
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=8e-6)
    np.testing.assert_allclose(out[1], ref[1], rtol=0, atol=3e-5)


def test_fuse_cloud_matches_jax():
    rng = np.random.default_rng(1)
    n = 20000
    pts = (rng.uniform(-1, 1, (n, 3)) * np.array([2.0, 1.5, 1.0])).astype(np.float32)
    # 2000 points on voxel boundaries: k * 0.04 rounded to float32
    pts[:2000] = (rng.integers(-25, 25, (2000, 3)) * 0.04).astype(np.float32)
    col = rng.random((n, 3)).astype(np.float32)
    mask = rng.random(n) < 0.9
    ref = [np.asarray(x) for x in jtex.fuse_cloud(jnp.asarray(pts), jnp.asarray(col),
                                                  jnp.asarray(mask))]
    out = [t.numpy() for t in ttex.fuse_cloud(torch.from_numpy(pts), torch.from_numpy(col),
                                              torch.from_numpy(mask))]
    # each point's voxel on both sides, as each computes it (XLA compiles
    # p / 0.04 as p * (1 / 0.04), the port divides): the same but for points
    # on a boundary
    q_ref = np.asarray(jax.jit(lambda p: jnp.floor(p / 0.04))(pts)).astype(np.int64)
    q_out = torch.floor(torch.from_numpy(pts) / 0.04).numpy().astype(np.int64)
    moved = mask & (q_ref != q_out).any(axis=1)
    frac = pts[moved] / np.float32(0.04)
    assert 0 < moved.sum() <= 2000, moved.sum()
    assert (np.abs(frac - np.round(frac)).min(axis=1) < 1e-5).all()
    # outputs are in ascending key order on both sides; match them by key on
    # the voxels that no boundary point enters or leaves
    bad = {tuple(k) for k in q_ref[moved]} | {tuple(k) for k in q_out[moved]}
    sets = [sorted({tuple(k) for k in q[mask]}) for q in (q_ref, q_out)]
    assert ref[1].sum() == len(sets[0]) and out[1].sum() == len(sets[1])
    rows = [{k: i for i, k in enumerate(v)} for v in sets]
    agree = [k for k in sets[0] if k not in bad]
    a = np.array([rows[0][k] for k in agree])
    b = np.array([rows[1][k] for k in agree])
    assert len(agree) > 10000
    np.testing.assert_allclose(out[0][b], ref[0][a], rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[2][b], ref[2][a], rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("colorize"))
    cfg_path, gt = make_dataset(root, n_frames=4, h_steps=900)
    cfg = jload_config(cfg_path)
    seed_sfm_state(cfg, gt)
    os.makedirs(cfg.joint_result_path, exist_ok=True)
    artifacts.export_pose_t(os.path.join(cfg.joint_result_path, "camera_pose_joint.txt"),
                            gt["R_wc"], gt["C"])
    artifacts.export_pose_t(
        os.path.join(cfg.joint_result_path, "lidar_pose_joint.txt"),
        np.stack([S @ p[0] @ S.T for p in gt["poses_lidar"]]),
        np.stack([S @ p[1] for p in gt["poses_lidar"]]))
    for f in sorted(glob.glob(os.path.join(cfg.image_path, "*.png"))):
        gray = cv2.imread(f, cv2.IMREAD_GRAYSCALE).astype(np.int32)
        bgr = np.stack([gray, (gray * 3) % 256, 255 - gray], axis=-1).astype(np.uint8)
        cv2.imwrite(f[:-4] + ".jpg", bgr, [cv2.IMWRITE_JPEG_QUALITY, 95])
        os.remove(f)
    ref = jpipe.colorize_lidar_map(cfg)
    pcd = os.path.join(cfg.texture_result_path, "colorized_map.pcd")
    with open(pcd, "rb") as f:
        ref_pcd = f.read()
    os.remove(pcd)
    out = tpipe.colorize_lidar_map(tload_config(cfg_path), device="cpu")
    with open(pcd, "rb") as f:
        out_pcd = f.read()
    return cfg, ref, out, ref_pcd, out_pcd


def _pcd_body(blob):
    end = blob.index(b"DATA binary\n") + len(b"DATA binary\n")
    return np.frombuffer(blob[end:], np.float32).reshape(-1, 4)


def test_stage_matches_jax_stage(dataset):
    _, (fused_ref, m_ref), (fused, m), ref_pcd, out_pcd = dataset
    assert m.sum() == m_ref.sum()
    np.testing.assert_allclose(fused[m], fused_ref[m_ref], rtol=0, atol=1e-6)
    a, b = _pcd_body(ref_pcd), _pcd_body(out_pcd)
    np.testing.assert_allclose(b[:, :3], a[:, :3], rtol=0, atol=1e-6)
    rgb_a, rgb_b = (np.ascontiguousarray(x[:, 3]).view(np.uint32) for x in (a, b))
    ch_a = np.stack([(rgb_a >> s) & 255 for s in (16, 8, 0)], 1).astype(int)
    ch_b = np.stack([(rgb_b >> s) & 255 for s in (16, 8, 0)], 1).astype(int)
    differ = ch_a != ch_b
    assert np.abs(ch_a - ch_b).max() <= 1
    assert differ.mean() < 1e-3, differ.mean()


def test_stage4_colorize(dataset):
    """The port of test_pipeline_cli_late.py::test_stage4_colorize."""
    cfg, _, (fused, fmask), _, out_pcd = dataset
    assert int(fmask.sum()) > 5000
    assert os.path.exists(os.path.join(cfg.texture_result_path, "colorized_map.pcd"))
    assert b"FIELDS x y z rgb\n" in out_pcd[:300]
