"""The port's LiDAR odometry stage as a whole (`python -m panovlm_tpu_torch
init_lidar_pose`) against the JAX stage (panovlm_tpu.pipeline.init_lidar_pose)
on one 6-frame synthetic Room dataset, built as tests/test_pipeline_cli.py
builds it, with result/sfm/lidar_pose.txt seeded from ground truth perturbed
by a seeded 2 cm / 0.5 deg Gaussian (scan 0 exact).

The JAX stage runs the way test_pipeline_cli.py runs it: under the test
conftest's 8-device CPU mesh, i.e. its sharded path, since ROADMAP F1 breaks
its single-device solve. That path associates with the default XLA KNN
(packed-key near-tie picks, ROADMAP F3) and sums its normal equations in
sharded order, so the port (exact KNN, on the CPU) is held to it per scan
within 5 mm in position and 0.1 deg in rotation. Both must also meet
test_stage2's ground-truth bound (consecutive-scan distance error < 0.05 m).

The undistorted re-estimate (lidar_pose_undis_refined.txt) is looser in the
whole-stage comparison: 5 mm and 0.2 deg. It starts from each package's own
first-round poses, which differ by ~0.005 deg, and on this 6-frame scene its
solve is weak in pitch (LM stops at its 20-iteration cap still moving), so
that seed difference grows to ~0.12 deg (measured). The round itself is held
to 5 mm and 0.1 deg separately, with both packages started from the same
poses (measured agreement there: < 0.01 deg, < 0.3 mm).

The port's stage runs a second time with its LM forced onto the PCG tier
(`LMOptions(dense_max_params=0)` in models/lidar_odometry.py), held to the
JAX stage's pose files within the same bounds.
"""

import copy
import functools
import os
import shutil

import numpy as np
import pytest
import torch

from synthetic import make_dataset
from panovlm_tpu import pipeline
from panovlm_tpu.config import load_config
from panovlm_tpu.io import artifacts
from panovlm_tpu.utils import poses as pose_util
from panovlm_tpu.utils.timing import TimeReport
from panovlm_tpu_torch import pipeline as tpipeline
from panovlm_tpu_torch.__main__ import main as torch_main
from panovlm_tpu_torch.models import lidar_odometry as tlo

torch.set_num_threads(2)

S = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])
POSE_FILES = ("lidar_pose_refined.txt", "lidar_pose_undis_refined.txt")
TOL_DEG = {"lidar_pose_refined.txt": 0.1, "lidar_pose_undis_refined.txt": 0.2}
ARTIFACTS = POSE_FILES + ("lidar_center_refined.pcd", "lidar_pose_refined.ply",
                          "lidar_center_undis_refined.pcd")


def _seed_sfm_poses(result_dir, gt, seed=0):
    """lidar_pose.txt in the camera-convention world the stage reads."""
    rng = np.random.default_rng(seed)
    from scipy.spatial.transform import Rotation as ScR
    R = np.stack([S @ p[0] @ S.T for p in gt["poses_lidar"]])
    t = np.stack([S @ p[1] for p in gt["poses_lidar"]])
    dR = ScR.from_rotvec(rng.normal(size=(len(R), 3)) * np.radians(0.5)).as_matrix()
    dt = rng.normal(size=t.shape) * 0.02
    dR[0], dt[0] = np.eye(3), 0.0
    os.makedirs(os.path.join(result_dir, "sfm"), exist_ok=True)
    artifacts.export_pose_t(os.path.join(result_dir, "sfm", "lidar_pose.txt"),
                            R @ dR, t + dt)


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("room"))
    cfg_path, gt = make_dataset(root, n_frames=6, h_steps=900,
                                config_overrides="num_iteration_lidar = 3\n")
    _seed_sfm_poses(os.path.join(root, "result"), gt)
    # the port writes into its own result and undistort directories
    text = open(cfg_path).read()
    text = text.replace(f"result_path = {root}/result",
                        f"result_path = {root}/result_torch")
    text = text.replace(f"lidar_path_undistort = {root}/result/undis",
                        f"lidar_path_undistort = {root}/result_torch/undis")
    torch_cfg_path = os.path.join(root, "config_torch.txt")
    with open(torch_cfg_path, "w") as f:
        f.write(text)
    os.makedirs(os.path.join(root, "result_torch", "sfm"))
    shutil.copy(os.path.join(root, "result", "sfm", "lidar_pose.txt"),
                os.path.join(root, "result_torch", "sfm", "lidar_pose.txt"))

    jcfg = load_config(cfg_path)
    pipeline.init_lidar_pose(jcfg)
    tcfg = load_config(torch_cfg_path)
    infos = []
    assert torch_main(["init_lidar_pose", torch_cfg_path, "--device", "cpu"],
                      infos=infos) == 0
    return jcfg, tcfg, gt, infos


def test_port_writes_every_artifact(stages):
    jcfg, tcfg, _, infos = stages
    for name in ARTIFACTS:
        assert os.path.exists(os.path.join(tcfg.odo_result_path, name)), name
        assert os.path.exists(os.path.join(jcfg.odo_result_path, name)), name
    und = sorted(os.listdir(tcfg.lidar_path_undistort))
    assert und == sorted(os.listdir(jcfg.lidar_path_undistort)) and len(und) == 6
    assert infos and all(i["pairs"] > 0 for i in infos)


def _pose_errors(Rj, tj, Rt, tt):
    pos_err = np.linalg.norm(tt - tj, axis=1)
    rot_err = np.degrees(np.arccos(np.clip(
        (np.einsum("nij,nij->n", Rt, Rj) - 1) / 2, -1, 1)))
    return pos_err, rot_err


@pytest.mark.parametrize("pose_file", POSE_FILES)
def test_port_poses_match_jax_stage(stages, pose_file):
    jcfg, tcfg, gt, _ = stages
    Rj, tj, _, okj = artifacts.read_pose_t(os.path.join(jcfg.odo_result_path, pose_file))
    Rt, tt, _, okt = artifacts.read_pose_t(os.path.join(tcfg.odo_result_path, pose_file))
    assert okj.all() and okt.all()
    pos_err, rot_err = _pose_errors(Rj, tj, Rt, tt)
    assert pos_err.max() < 0.005, pos_err
    assert rot_err.max() < TOL_DEG[pose_file], rot_err
    for t in (tj, tt):
        for i in range(5):
            d_gt = np.linalg.norm(gt["poses_lidar"][i + 1][1] - gt["poses_lidar"][i][1])
            assert abs(np.linalg.norm(t[i + 1] - t[i]) - d_gt) < 0.05, (pose_file, i)


def test_undistort_round_matches_jax_from_the_same_poses(stages, tmp_path):
    """Both undistort -> re-estimate rounds, started from the JAX stage's
    refined poses on the same scans."""
    jcfg, tcfg, _, _ = stages
    R, t, _, _ = artifacts.read_pose_t(
        os.path.join(jcfg.odo_result_path, "lidar_pose_refined.txt"))
    poses = pose_util.world_to_params(R, t)
    scans, valid, names = pipeline.load_scans(jcfg)
    out = {}
    for tag, cfg in (("jax", jcfg), ("torch", tcfg)):
        cfg = copy.copy(cfg)
        cfg.odo_result_path = str(tmp_path / tag)
        cfg.lidar_path_undistort = str(tmp_path / tag / "undis")
        os.makedirs(cfg.odo_result_path)
        if tag == "jax":
            p, _ = pipeline._undistort_round(cfg, TimeReport(), scans, valid,
                                             names, poses)
        else:
            p, _ = tpipeline._undistort_round(cfg, scans, valid, names, poses,
                                              torch.device("cpu"), [])
        out[tag] = pose_util.params_to_world(np.asarray(p))
    pos_err, rot_err = _pose_errors(*out["jax"], *out["torch"])
    assert pos_err.max() < 0.005, pos_err
    assert rot_err.max() < 0.1, rot_err


def test_port_stage_on_pcg_tier_matches_jax_stage(stages, tmp_path, monkeypatch):
    jcfg, tcfg, gt, _ = stages
    monkeypatch.setattr(tlo, "LMOptions", functools.partial(tlo.LMOptions, dense_max_params=0))
    cfg = copy.copy(tcfg)
    cfg.odo_result_path = str(tmp_path / "pcg")
    cfg.lidar_path_undistort = str(tmp_path / "pcg" / "undis")
    infos = []
    tpipeline.init_lidar_pose(cfg, device="cpu", infos=infos)
    assert infos and all(i["tier"] == "pcg" and i["cg_iterations"] for i in infos)
    for pose_file in POSE_FILES:
        Rj, tj, _, okj = artifacts.read_pose_t(os.path.join(jcfg.odo_result_path, pose_file))
        Rt, tt, _, okt = artifacts.read_pose_t(os.path.join(cfg.odo_result_path, pose_file))
        assert okt.all()
        pos_err, rot_err = _pose_errors(Rj, tj, Rt, tt)
        assert pos_err.max() < 0.005, (pose_file, pos_err)
        assert rot_err.max() < TOL_DEG[pose_file], (pose_file, rot_err)
        for i in range(5):
            d_gt = np.linalg.norm(gt["poses_lidar"][i + 1][1] - gt["poses_lidar"][i][1])
            assert abs(np.linalg.norm(tt[i + 1] - tt[i]) - d_gt) < 0.05, (pose_file, i)
