"""The port's joint stage (`python -m panovlm_tpu_torch joint_optimization`)
against the JAX stage (panovlm_tpu.pipeline.joint_optimization) on one
synthetic Room dataset seeded with ground-truth stage-1/2 artifacts, as
tests/test_pipeline_cli_late.py sets it up, cut to 3 frames (128 x 256) to
keep the test short (the JAX stage's sharded solve dominates its time at
any depth).

The JAX stage takes its sharded path there (tests/conftest.py gives it 8
CPU devices), which solves the normal equations with PCG; the port solves
them with the Schur tier and Cholesky. (Its single-device path would hit
F1: the LiDAR point-to-line block alone pads to 65,536 rows.) The test
requires:
  * the port's copy of test_stage3_joint_optimization: finite poses, every
    frame valid, camera centres within 0.08 m of ground truth;
  * the two stages' camera and LiDAR pose files within 3e-3 m (centres)
    and 0.1 deg (rotations) of each other. Measured: camera poses within
    2e-6 m and 2e-6 deg; LiDAR poses within 1.1 mm and 0.060 deg, a
    direction the camera-LiDAR terms constrain weakly, along which the JAX
    stage's PCG ends elsewhere than the port's Cholesky;
  * the reference's artifact set in result/joint/.
tests/test_torch_joint_cuda.py runs the stage twice on the card.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from panovlm_tpu import pipeline
from panovlm_tpu.config import load_config
from panovlm_tpu.io import artifacts
from panovlm_tpu_torch.__main__ import main as torch_main

from synthetic import make_dataset, seed_sfm_state

torch.set_num_threads(2)

ARTIFACTS = ("camera_pose_joint.txt", "lidar_pose_joint.txt", "points.npz",
             "camera_center_joint.pcd", "lidar_center_joint.pcd",
             "camera_pose_joint.ply", "lidar_pose_joint.ply")


def _copy(root, name):
    dst = os.path.join(os.path.dirname(root), name)
    shutil.copytree(root, dst)
    path = os.path.join(dst, "config.txt")
    with open(path) as f:
        text = f.read().replace(root, dst)
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("joint_stage") / "jax")
    cfg_path, gt = make_dataset(root, n_frames=3, h_steps=900, config_overrides=(
        "mvs_num_iterations = 2\nnum_iteration_lidar = 3\n"))
    seed_sfm_state(load_config(cfg_path), gt)
    port_cfg = _copy(root, "port")
    cfg = load_config(cfg_path)
    pipeline.joint_optimization(cfg)
    assert torch_main(["joint_optimization", port_cfg, "--device", "cpu"]) == 0
    return cfg, load_config(port_cfg), gt


def _rot_deg(Ra, Rb):
    c = (np.einsum("nij,nij->n", Ra, Rb) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


def test_port_stage3_joint_optimization(stages):
    _, pcfg, gt = stages
    for name in ARTIFACTS:
        assert os.path.exists(os.path.join(pcfg.joint_result_path, name)), name
    R, t, _, ok = artifacts.read_pose_t(os.path.join(pcfg.joint_result_path,
                                                     "camera_pose_joint.txt"))
    assert ok.all() and np.isfinite(R).all() and np.isfinite(t).all()
    err = np.abs(t - gt["C"]).max()
    assert err < 0.08, err
    pts = artifacts.read_point_tracks(os.path.join(pcfg.joint_result_path, "points.npz"))
    assert np.isfinite(pts["points"][pts["point_ok"]]).all()


@pytest.mark.parametrize("name", ["camera_pose_joint.txt", "lidar_pose_joint.txt"])
def test_port_joint_poses_match_jax(stages, name):
    cfg, pcfg, _ = stages
    Rj, tj, _, okj = artifacts.read_pose_t(os.path.join(cfg.joint_result_path, name))
    Rt, tt, _, okt = artifacts.read_pose_t(os.path.join(pcfg.joint_result_path, name))
    np.testing.assert_array_equal(okt, okj)
    assert np.abs(tt - tj).max() < 3e-3, np.abs(tt - tj).max()
    assert _rot_deg(Rt, Rj).max() < 0.1, _rot_deg(Rt, Rj).max()


def test_port_stage3_with_the_line_track_modes(stages):
    """The port's stage with use_image_track, use_lidar_track and
    use_track_associate on a copy of the same dataset: the artifact set,
    valid finite poses, camera centres within 0.08 m, and the TimeReport's
    "image line tracks" phase (the modes' parity with the JAX functions is
    tests/test_torch_camera_lidar.py's and tests/test_torch_line_tracks.py's)."""
    from panovlm_tpu_torch.utils.timing import TimeReport
    _, pcfg, gt = stages
    root = os.path.dirname(os.path.dirname(pcfg.joint_result_path))
    cfg_path = _copy(root, "port_tracks")
    with open(cfg_path, "a") as f:
        f.write("\nuse_image_track = true\nuse_lidar_track = true\n"
                "use_track_associate = true\n")
    tr = TimeReport()
    assert torch_main(["joint_optimization", cfg_path, "--device", "cpu"], tr=tr) == 0
    assert "image line tracks" in tr.time_spent
    tcfg = load_config(cfg_path)
    assert tcfg.use_image_track and tcfg.use_lidar_track and tcfg.use_track_associate
    for name in ARTIFACTS:
        assert os.path.exists(os.path.join(tcfg.joint_result_path, name)), name
    for name in ("camera_pose_joint.txt", "lidar_pose_joint.txt"):
        R, t, _, ok = artifacts.read_pose_t(os.path.join(tcfg.joint_result_path, name))
        assert ok.all() and np.isfinite(R).all() and np.isfinite(t).all()
    _, t, _, _ = artifacts.read_pose_t(os.path.join(tcfg.joint_result_path,
                                                    "camera_pose_joint.txt"))
    assert np.abs(t - gt["C"]).max() < 0.08
