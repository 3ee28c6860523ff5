"""The joint slice on the card (marked `cuda`: they skip where
torch.cuda.is_available() is false). No jax, cv2 or conftest fixtures, so
they run on the machine with the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_joint_cuda.py

  * the port's LSD builds there from native/lsd.cpp and finds the four
    edges of a rectangle (each within 1 px along at least 80 % of its
    length), with the same bits on two calls;
  * the SfM -> odometry -> joint chain on 8 frames of chip_smoke.py's Room
    loop (180 x 360): the joint stage twice gives bit-equal pose files and
    points (ROADMAP F9), with camera centres within 0.08 m of ground truth.
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from panovlm_tpu_torch.device import resolve
    return resolve("cuda")


@pytest.mark.cuda
def test_lsd_builds_and_finds_rectangle_edges(cuda_device):
    from panovlm_tpu_torch.native import lsd
    img = np.full((200, 300), 30, np.uint8)
    img[50:150, 80:230] = 200
    segs = lsd.detect(img)
    assert np.array_equal(segs, lsd.detect(img))
    for (x0, y0, x1, y1) in ((80, 50, 230, 50), (80, 150, 230, 150),
                             (80, 50, 80, 150), (230, 50, 230, 150)):
        horiz = y0 == y1
        near = [s for s in segs
                if (horiz and abs(s[1] - y0) < 1 and abs(s[3] - y0) < 1)
                or (not horiz and abs(s[0] - x0) < 1 and abs(s[2] - x0) < 1)]
        cover = max((abs(s[2] - s[0]) if horiz else abs(s[3] - s[1])) for s in near) \
            if near else 0
        assert cover >= 0.8 * (x1 - x0 if horiz else y1 - y0), (x0, y0, x1, y1, near)


@pytest.mark.cuda
def test_joint_stage_twice_on_the_card_is_bit_equal(cuda_device, tmp_path):
    import chip_smoke as cs
    from panovlm_tpu_torch.__main__ import main as port_main
    from panovlm_tpu_torch.config import load_config
    keys = cs.ROOM_SFM_KEYS.replace("num_sift                     = 8096",
                                    "num_sift                     = 2048")
    root = str(tmp_path)
    pool = multiprocessing.get_context("spawn").Pool(2)
    try:
        cfg_sfm, renders, gt = cs.start_sfm_dataset(root, 8, pool, hw=(180, 360), keys=keys)
        renders.get(timeout=600)
    finally:
        pool.terminate()
        pool.join()
    assert port_main(["init_camera_pose", cfg_sfm]) == 0
    cfg_path = os.path.join(root, "chain_config.txt")
    with open(cfg_path, "w") as f:
        f.write(open(cfg_sfm).read() + f"lidar_path_undistort = {root}/result/undis\n"
                "data_gap_time = 9.9\n" + cs.ROOM_ODOMETRY_KEYS + cs.ROOM_JOINT_KEYS)
    assert port_main(["init_lidar_pose", cfg_path]) == 0
    cfg = load_config(cfg_path)
    outs = []
    for _ in range(2):
        assert port_main(["joint_optimization", cfg_path]) == 0
        outs.append(cs._joint_outputs(cfg))
    assert outs[0] == outs[1]
    rot, dist, ok = cs.sfm_pose_errors(
        os.path.join(cfg.joint_result_path, "camera_pose_joint.txt"), gt)
    assert ok and rot < 1.0 and dist < 0.08, (rot, dist, ok)
