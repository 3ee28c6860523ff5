"""The port's SfM stage (`python -m panovlm_tpu_torch init_camera_pose`)
against the JAX stage (panovlm_tpu.pipeline.init_camera_pose) on one
synthetic Room dataset (synthetic.make_dataset, 6 frames, 128 x 256,
num_sift 2048), and the port's RefineCameraPose in `joint_mvs` against the
JAX stage's on a seed_sfm_state dataset.

Both stages run the config as written (sift_device false) with no frame
cache: the JAX stage detects with host cv2 SIFT, the port with its replay
of it (native/sift.cpp), and each writes its frames_sift.npz; the port's
must equal the JAX stage's: uv and fmask bit for bit, and each descriptor
row equal or, on at most 1 % of the rows, within 0.02 after RootSIFT,
since cv2 here takes its AVX-512 and IPP paths where the port replays the
AVX2 one (a raw value at a rounding half one level apart; see
tests/test_torch_sift_host.py). Then the port
computes everything after it: matching, relative poses (its own AC-RANSAC
draws, ROADMAP F5), averaging and BA. Both final pose files must pass the
ground-truth bounds of tests/test_pipeline_cli.py
(test_stage1_init_camera_pose: 1 deg, 0.08 m after aligning frame 0), and
the two must agree within 0.5 deg and 0.03 m.

RefineCameraPose: both stages run `joint_mvs` up to the neighbour
selection that follows the refinement (stopped there by a patched
`select_neighbor_views`, since the PatchMatch passes are not under test
here); their camera_pose_after_refine.txt agree within 0.01 deg and 1 mm.
"""

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

from synthetic import make_dataset, seed_sfm_state

torch.set_num_threads(2)


def _copy(root, name):
    dst = os.path.join(os.path.dirname(root), name)
    shutil.copytree(root, dst)
    path = os.path.join(dst, "config.txt")
    with open(path) as f:
        text = f.read().replace(root, dst)
    with open(path, "w") as f:
        f.write(text)
    return path


def _gt_errors(path, gt):
    """(max rotation error deg, max centre error m) of a pose file against
    ground truth, both aligned to frame 0 (test_stage1_init_camera_pose)."""
    R_wc, t_wc, _, ok = artifacts.read_pose_t(path)
    assert ok.all()
    R0, C0 = gt["R_wc"][0], gt["C"][0]
    R_gt = np.einsum("ij,njk->nik", R0.T, gt["R_wc"])
    C_gt = (gt["C"] - C0) @ R0
    rot = max(np.degrees(np.arccos(np.clip((np.trace(R_wc[i].T @ R_gt[i]) - 1) / 2, -1, 1)))
              for i in range(len(R_wc)))
    return rot, np.abs(t_wc - C_gt).max()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sfm_stage") / "data")
    cfg_path, gt = make_dataset(root, n_frames=6, h_steps=900)
    path_j, path_t = _copy(root, "jax"), _copy(root, "port")
    cfg_j, cfg_t = load_config(path_j), load_config(path_t)
    pipeline.init_camera_pose(cfg_j)
    assert not cfg_t.sift_device and not os.path.exists(cfg_t.frame_path)
    assert torch_main(["init_camera_pose", path_t, "--device", "cpu"]) == 0
    return dict(gt=gt, jax=cfg_j, port=cfg_t, path_t=path_t)


def _listing(cfg):
    out = set()
    for d, _, files in os.walk(cfg.result_path):
        for f in files:
            out.add(os.path.relpath(os.path.join(d, f), cfg.result_path))
    return out


def test_port_writes_the_jax_stage_artifacts(runs):
    a_j, a_t = _listing(runs["jax"]), _listing(runs["port"])
    # the same names: the depth visualisations are JPEG in both (ROADMAP F10)
    assert a_j == a_t
    for name in ("camera_pose_final.txt", "lidar_pose.txt", "points.npz", "frames.npz",
                 "match_pair.txt", "after_sift_match.txt", "camera_pose_beforeBA.txt",
                 "camera_pose_refine.txt", "structure.pcd"):
        assert os.path.join("sfm", name) in a_t, name
    for name in ("frames.npz", "points.npz"):
        z_j = artifacts.load_npz(os.path.join(runs["jax"].sfm_result_path, name))
        z_t = artifacts.load_npz(os.path.join(runs["port"].sfm_result_path, name))
        assert sorted(z_j) == sorted(z_t)
        for k in z_j:
            assert z_t[k].dtype == z_j[k].dtype, (name, k)
    for name in ("match_pairs.npz", "rel_poses.npz"):
        z_j = artifacts.load_npz(os.path.join(runs["jax"].match_pair_path, name))
        z_t = artifacts.load_npz(os.path.join(runs["port"].match_pair_path, name))
        assert {k: v.shape for k, v in z_j.items()} == {k: v.shape for k, v in z_t.items()}


def test_both_stages_reach_the_gt_bounds_and_agree(runs):
    errs = {}
    for key in ("jax", "port"):
        errs[key] = _gt_errors(os.path.join(runs[key].sfm_result_path,
                                            "camera_pose_final.txt"), runs["gt"])
        assert errs[key][0] < 1.0 and errs[key][1] < 0.08, (key, errs[key])
    R_j, t_j, _, _ = artifacts.read_pose_t(os.path.join(runs["jax"].sfm_result_path,
                                                        "camera_pose_final.txt"))
    R_t, t_t, _, _ = artifacts.read_pose_t(os.path.join(runs["port"].sfm_result_path,
                                                        "camera_pose_final.txt"))
    rot = max(np.degrees(np.arccos(np.clip((np.trace(R_t[i].T @ R_j[i]) - 1) / 2, -1, 1)))
              for i in range(len(R_t)))
    assert rot < 0.5 and np.abs(t_t - t_j).max() < 0.03, (rot, np.abs(t_t - t_j).max())


def test_rerun_reads_the_caches_back(runs):
    """A second port run takes matches and relative poses from its own row
    caches and lands on the same final poses."""
    cfg = runs["port"]
    before = open(os.path.join(cfg.sfm_result_path, "camera_pose_final.txt")).read()
    tpipeline.init_camera_pose(load_config(runs["path_t"]), device="cpu")
    after = open(os.path.join(cfg.sfm_result_path, "camera_pose_final.txt")).read()
    assert after == before


def _frames(cfg):
    return artifacts.load_npz(os.path.join(cfg.frame_path, "frames_sift.npz"))


def _same_features(got, want):
    """uv and fmask bit for bit; each row's descriptor equal to the JAX
    stage's, or (a value at a rounding half one level apart in cv2's raw
    descriptor) within 0.02 after RootSIFT, on at most 1 % of the rows."""
    assert np.array_equal(got["fmask"], want["fmask"])
    assert np.array_equal(got["uv"].view(np.uint32), want["uv"].view(np.uint32))
    d = np.abs(got["desc"] - want["desc"]).max(axis=2)
    assert d.max() < 0.02 and (d > 0).sum() <= 0.01 * want["fmask"].sum(), (d.max(), (d > 0).sum())


def test_port_stage_writes_the_jax_frame_cache(runs):
    """The port's init_camera_pose with sift_device = false and no frame
    cache wrote the JAX stage's frames_sift.npz."""
    _same_features(_frames(runs["port"]), _frames(runs["jax"]))


def test_host_sift_batch_gives_the_jax_frame_cache(runs):
    """utils/sift.extract_sift_batch on the dataset's frames, as the stage
    calls it, on 1 and on 4 threads: equal to each other and to the JAX
    stage's frames_sift.npz."""
    from panovlm_tpu_torch.io import images
    from panovlm_tpu_torch.utils import sift as port_sift
    cfg = runs["port"]
    grays, _ = images.load_images_u8(cfg.image_path, cfg.scale)
    want = _frames(runs["jax"])
    outs = [port_sift.extract_sift_batch(grays, int(cfg.num_sift), root_sift=cfg.root_sift,
                                         num_threads=t) for t in (1, 4)]
    for a, b in zip(*outs):
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    _same_features(dict(zip(("uv", "desc", "fmask"), outs[0])), want)
    assert want["fmask"].sum(1).min() > 100


class _Stop(Exception):
    pass


def _stop(*_a, **_k):
    raise _Stop()


def test_refine_camera_pose_matches_the_jax_stage(tmp_path, monkeypatch):
    from panovlm_tpu.models import mvs as jmvs
    from panovlm_tpu_torch.models import mvs as tmvs
    root = str(tmp_path / "data")
    cfg_path, gt = make_dataset(root, n_frames=4, H=64, W=128, h_steps=450)
    seed_sfm_state(load_config(cfg_path), gt, n_points=300)
    cfg = load_config(cfg_path)
    # joint poses: ground truth perturbed, so the refinement has work to do
    rng = np.random.default_rng(1)
    from scipy.spatial.transform import Rotation as ScR
    dR = ScR.from_rotvec(rng.normal(size=(4, 3)) * np.radians(0.3)).as_matrix()
    dR[0] = np.eye(3)
    dt = rng.normal(size=(4, 3)) * 0.01
    dt[0] = 0.0
    R_l, t_l, _, _ = artifacts.read_pose_t(os.path.join(cfg.odo_result_path,
                                                        "lidar_pose_refined.txt"))
    artifacts.export_pose_t(os.path.join(cfg.joint_result_path, "camera_pose_joint.txt"),
                            gt["R_wc"] @ dR, gt["C"] + dt)
    artifacts.export_pose_t(os.path.join(cfg.joint_result_path, "lidar_pose_joint.txt"),
                            R_l, t_l)
    path_j, path_t = _copy(root, "jax"), _copy(root, "port")
    monkeypatch.setattr(jmvs, "select_neighbor_views", _stop)
    monkeypatch.setattr(tmvs, "select_neighbor_views", _stop)
    with pytest.raises(_Stop):
        pipeline.joint_mvs(load_config(path_j))
    with pytest.raises(_Stop):
        tpipeline.joint_mvs(load_config(path_t), device="cpu")
    out = {}
    for key, path in (("jax", path_j), ("port", path_t)):
        c = load_config(path)
        out[key] = artifacts.read_pose_t(os.path.join(c.mvs_result_path,
                                                      "camera_pose_after_refine.txt"))
    R_j, t_j, names_j, _ = out["jax"]
    R_t, t_t, names_t, _ = out["port"]
    assert names_t == names_j
    rot = max(np.degrees(np.arccos(np.clip((np.trace(R_t[i].T @ R_j[i]) - 1) / 2, -1, 1)))
              for i in range(4))
    assert rot < 0.01 and np.abs(t_t - t_j).max() < 1e-3, (rot, np.abs(t_t - t_j).max())
    # the refinement moved the poses: it is not the joint input written back
    assert np.abs(t_t - (gt["C"] + dt)).max() > 1e-4
