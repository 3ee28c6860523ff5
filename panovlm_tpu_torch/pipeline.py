"""Stage functions of the port — the LiDAR odometry stage so far
(`init_lidar_pose`, the reference's InitLidarPose, main.cpp:372-452), ported
from `panovlm_tpu/pipeline.py:665-830`. It reads and writes the same
artifacts as the JAX stage:

  result/sfm/lidar_pose.txt               (input, stage 1's lidar poses)
  result/odometry/lidar_pose_refined.txt, lidar_center_refined.pcd,
                  lidar_pose_refined.ply
  <lidar_path_undistort>/*.pcd            (undistorted clouds)
  result/odometry/lidar_pose_undis_refined.txt, lidar_center_undis_refined.pcd
"""

from __future__ import annotations

import glob
import os

import numpy as np
import torch

from panovlm_tpu.config import Config
from panovlm_tpu.io import artifacts, pointcloud
from panovlm_tpu.utils import poses as pose_util
from panovlm_tpu.utils import visualization as viz
from panovlm_tpu.utils.timing import TimeReport

from .models import lidar_odometry
from .sensors import velodyne as vd

# Scans extracted per batch: bounds the (scans x 2048 x 1024) line-hypothesis
# temporaries of sensors/lidar_lines.py to a few GB.
EXTRACT_BATCH = 64


def _list_files(path, exts):
    out = []
    for e in exts:
        out += glob.glob(os.path.join(path, f"*.{e}"))
    return sorted(out)


def load_scans(cfg: Config):
    """Load + preprocess all scans of cfg.lidar_path (native threaded
    prefetcher, numpy fallback)."""
    from panovlm_tpu.native import ScanPrefetcher
    files = _list_files(cfg.lidar_path, ("pcd", "ply"))
    scans, valid, names = [], [], []
    pf = ScanPrefetcher(files, n_threads=4)
    try:
        for f, raw in zip(files, pf):
            if raw is None:  # native read failed; retry with the numpy path
                raw = pointcloud.load_cloud(f)
            pts, ok = vd.preprocess_cloud(raw)
            scans.append(pts)
            valid.append(ok)
            names.append(os.path.basename(f))
    finally:
        pf.close()
    return scans, np.asarray(valid), names


def _scan_cap(scans, quantum: int = 8192, max_cap: int = 32768) -> int:
    """Per-dataset point cap: the longest scan rounded up to a quantum."""
    longest = max((len(s) for s in scans), default=max_cap)
    return int(min(max_cap, max(quantum, -(-longest // quantum) * quantum)))


def extract_all_features(scans, cap: int, cfg: Config, device):
    """Feature extraction for every scan, batched over scans (EXTRACT_BATCH
    at a time). Returns the stacked feature dict on `device`."""
    kw = dict(max_curvature=cfg.max_curvature,
              intersect_angle_threshold=cfg.intersection_angle_threshold,
              segment=cfg.lidar_segmentation, method=cfg.extraction_method,
              repair_rings=cfg.lidar_ring_repair)
    outs = []
    for c0 in range(0, len(scans), EXTRACT_BATCH):
        pads = [vd.pad_points(p, cap) for p in scans[c0:c0 + EXTRACT_BATCH]]
        pts = torch.from_numpy(np.stack([p for p, _ in pads])).to(device)
        msk = torch.from_numpy(np.stack([m for _, m in pads])).to(device)
        outs.append(vd.extract_features(pts, msk, **kw))
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def _odometry_config(cfg: Config) -> lidar_odometry.OdometryConfig:
    return lidar_odometry.OdometryConfig(
        num_iteration_lidar=cfg.num_iteration_lidar,
        angle_residual=cfg.angle_residual,
        normalize_distance=cfg.normalize_distance,
        point_to_line=cfg.point_to_line_residual,
        line_to_line=cfg.line_to_line_residual,
        point_to_plane=cfg.point_to_plane_residual)


def init_lidar_pose(cfg: Config, tr: TimeReport | None = None, device="cuda",
                    infos: list | None = None):
    """LiDAR odometry + undistortion (InitLidarPose, main.cpp:372-452).
    Returns (poses (N, 6) numpy, valid). When `infos` is a list, the
    per-round solver records of both odometry runs are appended to it."""
    device = torch.device(device)
    tr = tr or TimeReport()
    infos = [] if infos is None else infos
    os.makedirs(cfg.odo_result_path, exist_ok=True)
    with tr.phase("load scans"):
        scans, valid, names = load_scans(cfg)
    with tr.phase("load sfm-seeded lidar poses"):
        R_wl, t_wl, _, pose_ok = artifacts.read_pose_t(
            os.path.join(cfg.sfm_result_path, "lidar_pose.txt"))
        valid = valid & pose_ok[:len(valid)]
        poses0 = pose_util.world_to_params(
            np.where(pose_ok[:, None, None], R_wl, np.eye(3)),
            np.where(pose_ok[:, None], t_wl, 0.0))
    with tr.phase("extract features"):
        batch = extract_all_features(scans, _scan_cap(scans), cfg, device)
    with tr.phase("estimate poses"):
        poses_t, round_infos = lidar_odometry.estimate_poses(
            batch, poses0, valid, _odometry_config(cfg))
        poses = poses_t.cpu().numpy()
        infos.extend(round_infos)
    with tr.phase("export"):
        R, t = pose_util.params_to_world(poses)
        artifacts.export_pose_t(
            os.path.join(cfg.odo_result_path, "lidar_pose_refined.txt"), R, t, names)
        viz.camera_centers_pcd(
            os.path.join(cfg.odo_result_path, "lidar_center_refined.pcd"), poses, valid)
        viz.camera_pose_ply(
            os.path.join(cfg.odo_result_path, "lidar_pose_refined.ply"), poses, valid)

    # undistort with the solved poses, re-estimate, export the undistorted
    # clouds + poses (main.cpp:414-448, max_iter = 1)
    if cfg.lidar_path_undistort:
        with tr.phase("undistort + re-estimate"):
            poses, valid = _undistort_round(cfg, scans, valid, names, poses,
                                            device, infos)
    return poses, valid


def _undistort_round(cfg: Config, scans, valid, names, poses, device, infos):
    """One undistort -> re-estimate round (main.cpp:414-448, max_iter = 1):
    slerp each point's pose between its scan's and the next valid scan's
    (LidarOdometry::UndistortLidars, LidarOdometry.cpp:189-263), write the
    undistorted clouds (original z-up frame, intensity = sweep time), then
    rerun the odometry on them."""
    os.makedirs(cfg.lidar_path_undistort, exist_ok=True)
    n = len(scans)
    valid_ids = [i for i in range(n) if valid[i]]
    lens = [len(s) for s in scans]
    pts_np, msk_np = zip(*[vd.pad_points(s, max(max(lens), 1)) for s in scans])
    pts_b = torch.from_numpy(np.stack(pts_np)).to(device)
    msk_b = torch.from_numpy(np.stack(msk_np)).to(device)
    frac_b = vd.sweep_fraction_from(pts_b, vd.scan_start_ori(pts_b, msk_b))

    # per scan: the interpolation target and the sweep scale. The next valid
    # scan's pose; the last scan extrapolates with constant relative motion
    # (LidarOdometry.cpp:210-236). A gap of (j - i) scans puts the sweep-end
    # pose at alpha = duration / ((j-i)*(duration+gap)) along the geodesic.
    duration = 0.1
    alphas = np.zeros(n, np.float32)
    pose_next = np.array(poses, np.float32, copy=True)
    for i in range(n):
        if not (valid[i] and len(valid_ids) > 1):
            continue  # alpha 0 -> undistort is the identity
        later = [j for j in valid_ids if j > i]
        if later:
            j = later[0]
            pose_next[i] = poses[j]
            alphas[i] = duration / ((j - i) * (duration + cfg.data_gap_time))
        else:
            prev = [j for j in valid_ids if j < i][-1]
            p_prev, p_i = poses[prev], poses[i]
            pose_next[i] = p_i + (p_i - p_prev) / (i - prev)
            alphas[i] = duration / (duration + cfg.data_gap_time)

    und_b = lidar_odometry.undistort_scan(
        pts_b, frac_b * torch.from_numpy(alphas).to(device)[:, None],
        torch.from_numpy(np.asarray(poses, np.float32)).to(device),
        torch.from_numpy(pose_next).to(device))
    und_np, frac_np = und_b.cpu().numpy(), frac_b.cpu().numpy()

    undist = []
    for i, m in enumerate(lens):
        p = und_np[i, :m].astype(np.float32)
        undist.append(p)
        raw = p @ vd.AXIS_SWAP  # back to the sensor's z-up frame (S^-1 = S^T)
        pointcloud.write_pcd(os.path.join(cfg.lidar_path_undistort, names[i]),
                             raw if m else np.zeros((1, 3), np.float32),
                             intensity=frac_np[i, :m] if m else np.zeros(1, np.float32),
                             binary=True)

    batch = extract_all_features(undist, _scan_cap(undist), cfg, device)
    poses2_t, round_infos = lidar_odometry.estimate_poses(
        batch, poses, valid, _odometry_config(cfg))
    infos.extend(round_infos)
    poses2 = poses2_t.cpu().numpy()
    R, t = pose_util.params_to_world(poses2)
    artifacts.export_pose_t(
        os.path.join(cfg.odo_result_path, "lidar_pose_undis_refined.txt"), R, t, names)
    viz.camera_centers_pcd(
        os.path.join(cfg.odo_result_path, "lidar_center_undis_refined.pcd"),
        poses2, valid)
    return poses2, valid
