"""Stage 4 on the card (marked `cuda`: they skip where
torch.cuda.is_available() is false). No jax, cv2 or conftest fixtures, so
they run on the machine with the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_colorize_cuda.py

The dataset is chip_smoke.py's MVS dataset at 4 frames, its colour JPEG
panoramas rendered at 256 x 512 and read at scale -2 (64 x 128), its
full-width scans and ground-truth joint poses.

  * texture.colorize_lidar_map and fuse_cloud on the card against the
    port on the CPU, on the inputs the stage loads: ok equal; points within
    8e-6 m and colours within 3e-5 (the card's and the CPU's sin, cos and
    atan2 differ in the last bits, as XLA's and PyTorch's do: the bounds of
    tests/test_torch_colorize.py); the voxel keys of the points the same
    except for points within float rounding of a voxel boundary (each
    within 1e-5 of an integer in p / 0.04); on the voxels whose members
    agree, centroids within 8e-6 m and colours within 3e-5;
  * the stage run twice on the card writes the same colorized_map.pcd,
    byte for byte.
"""

import multiprocessing
import os
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def color_config(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    import chip_smoke as cs
    from panovlm_tpu_torch.device import resolve
    resolve("cuda")
    root = str(tmp_path_factory.mktemp("colorize_cuda"))
    pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        cfg_path, depths = cs.start_mvs_dataset(root, 4, pool, pano_hw=(256, 512))
        depths.get(timeout=600)
    finally:
        pool.terminate()
        pool.join()
    path = os.path.join(root, "color_config.txt")
    with open(cfg_path) as f:
        text = f.read().replace(f"image_path = {root}/images", f"image_path = {root}/color")
    with open(path, "w") as f:
        f.write(text)
    return path


def _stage_inputs(cfg_path):
    """What pipeline.colorize_lidar_map hands to texture.colorize_lidar_map."""
    from panovlm_tpu_torch import pipeline
    from panovlm_tpu_torch.config import load_config
    from panovlm_tpu_torch.io import artifacts, images
    from panovlm_tpu_torch.sensors import velodyne as vd
    from panovlm_tpu_torch.utils import poses as pose_util
    cfg = load_config(cfg_path)
    colors, _ = images.load_images_u8(cfg.image_path, cfg.scale, color=True)
    scans, valid, _ = pipeline.load_scans(cfg, path=cfg.lidar_path_undistort)
    poses = [pose_util.world_to_params(*artifacts.read_pose_t(os.path.join(
        cfg.joint_result_path, f"{kind}_pose_joint.txt"))[:2]) for kind in ("lidar", "camera")]
    cap = pipeline._scan_cap(scans)
    pads = [vd.pad_points(s, cap) for s in scans]
    pts = np.stack([p for p, _ in pads])
    msk = np.stack([m for _, m in pads]) & valid[:, None]
    return pts, msk, poses[0], np.stack(colors), poses[1]


@pytest.mark.cuda
def test_colorize_on_card_matches_cpu(color_config):
    from panovlm_tpu_torch.models import texture
    pts, msk, lp, imgs, cp = _stage_inputs(color_config)
    out = {}
    for dev in ("cpu", "cuda"):
        p_w, col, ok = texture.colorize_lidar_map(pts, msk, lp, imgs, cp, device=dev)
        fused = texture.fuse_cloud(p_w, col, ok)
        keys = torch.floor(p_w / 0.04)          # as voxel_downsample computes them there
        out[dev] = [t.cpu().numpy() for t in (p_w, col, ok, *fused, keys)]
    cpu, card = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(card[2], cpu[2])
    assert cpu[2].sum() > 50000
    np.testing.assert_allclose(card[0], cpu[0], rtol=0, atol=8e-6)
    np.testing.assert_allclose(card[1], cpu[1], rtol=0, atol=3e-5)
    ok = cpu[2]
    q_cpu, q_card = cpu[6].astype(np.int64), card[6].astype(np.int64)
    moved = ok & (q_cpu != q_card).any(axis=1)
    frac = cpu[0][moved] / np.float32(0.04)
    assert (np.abs(frac - np.round(frac)).min(axis=1) < 1e-5).all()
    bad = {tuple(k) for k in q_cpu[moved]} | {tuple(k) for k in q_card[moved]}
    sets = {d: sorted({tuple(k) for k in q[ok]}) for d, q in (("cpu", q_cpu), ("cuda", q_card))}
    assert cpu[4].sum() == len(sets["cpu"]) and card[4].sum() == len(sets["cuda"])
    rows = {d: {k: i for i, k in enumerate(v)} for d, v in sets.items()}
    agree = [k for k in sets["cpu"] if k not in bad]
    a = np.array([rows["cpu"][k] for k in agree])
    b = np.array([rows["cuda"][k] for k in agree])
    np.testing.assert_allclose(card[3][b], cpu[3][a], rtol=0, atol=8e-6)
    np.testing.assert_allclose(card[5][b], cpu[5][a], rtol=0, atol=3e-5)


@pytest.mark.cuda
def test_colorize_stage_rerun_is_bit_equal(color_config):
    from panovlm_tpu_torch import pipeline
    from panovlm_tpu_torch.config import load_config
    cfg = load_config(color_config)
    path = os.path.join(cfg.texture_result_path, "colorized_map.pcd")
    blobs = []
    for _ in range(2):
        fused, fmask = pipeline.colorize_lidar_map(cfg, device="cuda")
        assert fmask.sum() > 5000
        with open(path, "rb") as f:
            blobs.append(f.read())
    assert blobs[0] == blobs[1]
