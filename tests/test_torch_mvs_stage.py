"""The port's MVS stage as a whole (`python -m panovlm_tpu_torch joint_mvs`)
against the JAX stage (panovlm_tpu.pipeline.joint_mvs) on one synthetic
Room dataset: 4 frames, ground-truth joint camera and LiDAR poses (the
seed_sfm_state convention), no SfM state (so no RefineCameraPose: that is
tests/test_torch_sfm_stage.py), the Room
MVS keys of configs/Room.txt:75-87 (sweep slices 64 with the range fit,
sequential propagation, 7x7 texels, LiDAR init kept constant, geometric
pass) at scale 0 and 2 PatchMatch iterations.

The JAX stage runs under the test conftest's 8-device CPU mesh, as
tests/test_pipeline_cli_late.py runs it. The two packages draw different
random numbers (ROADMAP F5), so they are compared at the level of the
result: the same artifact names, shapes and dtypes, both within the median
relative depth error of test_pipeline_cli_late.py (< 0.08 against
render_panorama in rows H/4..3H/4, here over all frames), the two medians
within 0.03 of each other, and the port's share of those rows with a depth
(its coverage) at least COVERAGE_SHARE of the JAX stage's.

The panoramas are 128 x 256: at 64 x 128 both packages miss the bound,
since the LiDAR depth init's splat and dilation cover several degrees per
pixel there.

With a mask (the `masked` fixture): both stages again on copies of their
trees, resumed from their pass artifacts (the mask enters after the
passes, main.cpp:610), with a tripod-style mask at half the panorama size
as an RLE8 BMP named mask.png, which the JAX stage reads with cv2 and the
port with native/bmp.cpp; the port also with the same mask as a PNG.
"""

import glob
import os
import shutil

import numpy as np
import pytest
import torch

from panovlm_tpu import pipeline
from panovlm_tpu.config import load_config
from panovlm_tpu.io import artifacts
from panovlm_tpu_torch import pipeline as tpipeline
from panovlm_tpu_torch.__main__ import main as torch_main
from panovlm_tpu_torch.io import images

import image_forge as forge
from synthetic import make_dataset, render_panorama

torch.set_num_threads(2)

S = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
ROOM_MVS_KEYS = """\
mvs_use_lidar        = true
ncc_half_window      = 3
ncc_step             = 1
propagate_strategy   = 2
depth_diff_threshold = 0.01
min_segment          = 100
mvs_use_geometric    = true
keep_lidar_constant  = true
mvs_sweep_slices     = 64
mvs_num_iterations   = 2
"""
# the port must cover at least this share of what the JAX stage covers, so
# that neither median can pass on the few pixels a faulty stage keeps
COVERAGE_SHARE = 0.8


def _joint_poses(cfg, gt):
    """GT stage-3 outputs: camera poses and the LiDAR poses in the
    camera-convention world (as synthetic.seed_sfm_state writes them)."""
    R_wl = np.stack([S @ p[0] @ S.T for p in gt["poses_lidar"]])
    t_wl = np.stack([S @ p[1] for p in gt["poses_lidar"]])
    artifacts.export_pose_t(os.path.join(cfg.joint_result_path, "camera_pose_joint.txt"),
                            gt["R_wc"], gt["C"])
    artifacts.export_pose_t(os.path.join(cfg.joint_result_path, "lidar_pose_joint.txt"),
                            R_wl, t_wl)


def _copy(root, name):
    dst = os.path.join(os.path.dirname(root), name)
    shutil.copytree(root, dst)
    path = os.path.join(dst, "config.txt")
    with open(path) as f:
        text = f.read().replace(root, dst)
    with open(path, "w") as f:
        f.write(text)
    return load_config(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mvs_stage") / "data")
    cfg_path, gt = make_dataset(root, n_frames=4, H=128, W=256, h_steps=900,
                                config_overrides=ROOM_MVS_KEYS)
    cfg = load_config(cfg_path)
    os.makedirs(cfg.joint_result_path)
    _joint_poses(cfg, gt)
    cfg_j, cfg_t = _copy(root, "jax"), _copy(root, "port")
    depths_j, _ = pipeline.joint_mvs(cfg_j)
    assert torch_main(["joint_mvs", os.path.join(os.path.dirname(cfg_t.result_path),
                                                 "config.txt"), "--device", "cpu"]) == 0
    # rerun on the finished tree with a saved refinement: the stage-internal
    # resume (the refine file, then every pass's artifacts) skips the passes
    artifacts.export_pose_t(os.path.join(cfg_t.mvs_result_path,
                                         "camera_pose_after_refine.txt"),
                            gt["R_wc"], gt["C"])
    depths_t, confs_t = tpipeline.joint_mvs(cfg_t, device="cpu")
    return dict(gt=gt, jax=(cfg_j, depths_j), port=(cfg_t, depths_t, confs_t))


def _artifacts(cfg):
    out = {}
    for f in sorted(glob.glob(os.path.join(cfg.mvs_data_path, "*", "*.npy"))):
        a = np.load(f)
        out[os.path.relpath(f, cfg.mvs_data_path)] = (a.shape, a.dtype)
    fused = os.path.join(cfg.mvs_result_path, "mvs_fused.pcd")
    out["mvs_fused.pcd"] = os.path.exists(fused)
    return out


def _median_rel_error(depths, gt):
    """(median relative depth error, coverage) in rows H/4..3H/4."""
    errs, cover = [], []
    for i, d in enumerate(depths):
        H, W = d.shape
        _, d_gt = render_panorama(gt["C"][i], H, W, R_wc=gt["R_wc"][i])
        have = np.zeros_like(d, bool)
        have[H // 4:3 * H // 4] = True
        band = have.sum()
        have &= (d > 0) & np.isfinite(d_gt) & (d_gt > 0)
        errs.append(np.abs(d - d_gt)[have] / d_gt[have])
        cover.append(have.sum() / band)
    return float(np.median(np.concatenate(errs))), float(np.mean(cover))


def test_port_writes_the_jax_stage_artifacts(runs):
    a_j, a_t = _artifacts(runs["jax"][0]), _artifacts(runs["port"][0])
    assert a_t == a_j
    assert a_j["mvs_fused.pcd"]
    assert len(a_j) == 4 * 7 + 1    # {pho,geo,filter} depth, {pho,geo} conf + normal
    assert a_j["depth/000000_geo.npy"] == ((128, 256), np.uint16)
    assert a_j["normal/000000_geo.npy"] == ((128, 256, 3), np.float32)


def test_both_stages_reach_the_depth_bound_and_agree(runs):
    med_j, cov_j = _median_rel_error(runs["jax"][1], runs["gt"])
    med_t, cov_t = _median_rel_error(runs["port"][1], runs["gt"])
    assert med_j < 0.08, med_j
    assert med_t < 0.08, med_t
    assert abs(med_t - med_j) < 0.03, (med_t, med_j)
    assert cov_t >= COVERAGE_SHARE * cov_j, (cov_t, cov_j)


def test_resumed_run_reads_back_the_pass_artifacts(runs):
    """The second port run took the saved refinement and found every _geo
    artifact, so it skipped both passes and read the u16 maps back."""
    cfg, depths, confs = runs["port"]
    conf0 = artifacts.read_conf_u16(os.path.join(cfg.mvs_conf_path, "000000_geo.npy"))
    np.testing.assert_array_equal(confs[0], conf0)
    assert (depths > 0).mean() > 0.1


def test_unported_refinement_and_neighbour_selection_raise(runs):
    """RefineCameraPose is ported (tests/test_torch_sfm_stage.py): with SfM
    state files that hold no tracks it fails on their content, not as
    unported; min_depth 0 raises (F7). Neighbour selection 1 is ported
    (tests/test_torch_mvs_options.py)."""
    cfg = _copy(os.path.dirname(runs["port"][0].result_path), "refine")
    for name in ("frames.npz", "points.npz"):
        os.makedirs(cfg.sfm_result_path, exist_ok=True)
        np.savez(os.path.join(cfg.sfm_result_path, name), x=np.zeros(1))
    os.remove(os.path.join(cfg.mvs_result_path, "camera_pose_after_refine.txt"))
    with pytest.raises(KeyError):
        tpipeline.joint_mvs(cfg, device="cpu")
    cfg.min_depth = 0.0
    with pytest.raises(ValueError, match="F7"):
        tpipeline.joint_mvs(cfg, device="cpu")


# ----------------------------------------------------------------------------
# the stages with a mask
# ----------------------------------------------------------------------------

def _tripod(h, w):
    """255 where usable; the bottom eighth of the rows and a pole (w / 16
    columns from the horizon down) cleared."""
    m = np.full((h, w), 255, np.uint8)
    m[h - h // 8:] = 0
    m[h // 2:, w // 2 - w // 32:w // 2 + w // 32] = 0
    return m


def _with_mask(src_cfg, name, mask_path):
    """A copy of a finished stage tree whose config reads mask_path."""
    cfg = _copy(os.path.dirname(src_cfg.result_path), name)
    path = os.path.join(os.path.dirname(cfg.result_path), "config.txt")
    with open(path, "a") as f:
        f.write(f"mask_path = {mask_path}\n")
    return path


def _tree(cfg):
    out = {}
    for top in (cfg.mvs_data_path, cfg.mvs_result_path):
        for f in sorted(glob.glob(os.path.join(top, "**", "*"), recursive=True)):
            if os.path.isfile(f):
                with open(f, "rb") as fh:
                    out[os.path.relpath(f, top)] = fh.read()
    return out


@pytest.fixture(scope="module")
def masked(runs, tmp_path_factory):
    d = tmp_path_factory.mktemp("masks")
    m = _tripod(64, 128)
    os.makedirs(d / "bmp")
    paths = {"bmp": str(d / "bmp" / "mask.png"), "png": str(d / "mask.png")}
    with open(paths["bmp"], "wb") as f:
        f.write(forge.bmp_bytes((m > 0).astype(np.uint8), 8, [[0, 0, 0], [255, 255, 255]],
                                rle=True))
    images.write_png(paths["png"], m)
    cfg_j = load_config(_with_mask(runs["jax"][0], "jax_bmp_mask", paths["bmp"]))
    depths_j, _ = pipeline.joint_mvs(cfg_j)
    out = {"jax": (cfg_j, depths_j)}
    for kind in ("bmp", "png"):
        path = _with_mask(runs["port"][0], f"port_{kind}_mask", paths[kind])
        assert torch_main(["joint_mvs", path, "--device", "cpu"]) == 0
        cfg_t = load_config(path)
        out[kind] = (cfg_t, tpipeline.joint_mvs(cfg_t, device="cpu")[0])
    out["mask"] = np.repeat(np.repeat(m > 0, 2, axis=0), 2, axis=1)
    return out


def _filtered(cfg, i):
    return artifacts.read_depth_u16(os.path.join(cfg.mvs_depth_path, f"{i:06d}_filter.npy"))


def test_port_with_a_bmp_mask_writes_the_jax_stage_artifacts(runs, masked):
    """The JAX stage and the port with the same BMP mask: the same artifact
    set; in each, fewer filtered depths in the masked pixels than without
    the mask (the mask clears them before the post-processing, whose gap
    interpolation and filter may give some back); the depth bounds and
    agreement of the unmasked runs."""
    cfg_j, depths_j = masked["jax"]
    cfg_t, depths_t = masked["bmp"]
    assert _artifacts(cfg_t) == _artifacts(cfg_j)
    off = ~masked["mask"]
    for with_mask, without in ((cfg_j, runs["jax"][0]), (cfg_t, runs["port"][0])):
        have = [sum(int((_filtered(cfg, i)[off] > 0).sum()) for i in range(4))
                for cfg in (with_mask, without)]
        assert have[0] < have[1], have
    med_j, cov_j = _median_rel_error(depths_j, runs["gt"])
    med_t, cov_t = _median_rel_error(depths_t, runs["gt"])
    assert med_j < 0.08 and med_t < 0.08, (med_j, med_t)
    assert abs(med_t - med_j) < 0.03, (med_t, med_j)
    assert cov_t >= COVERAGE_SHARE * cov_j, (cov_t, cov_j)


def test_png_and_bmp_masks_give_the_same_bits(masked):
    """load_mask reads the two files to the same booleans, and the port's
    runs with them write the same bytes in every artifact."""
    a = images.load_mask(masked["png"][0].mask_path, 128, 256)
    b = images.load_mask(masked["bmp"][0].mask_path, 128, 256)
    np.testing.assert_array_equal(a, masked["mask"])
    np.testing.assert_array_equal(b, masked["mask"])
    tree_png, tree_bmp = _tree(masked["png"][0]), _tree(masked["bmp"][0])
    assert len(tree_png) == 4 * 7 + 2 and "mvs_fused.pcd" in tree_png
    assert tree_png == tree_bmp
    np.testing.assert_array_equal(masked["png"][1], masked["bmp"][1])
