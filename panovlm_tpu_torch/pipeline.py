"""Stage functions of the port. Each reads and writes the same artifacts
as its JAX stage in panovlm_tpu/pipeline.py.

`init_camera_pose` (InitCameraPose, main.cpp:91-370; JAX pipeline.py:168-662):

  <frame_path>/frames_sift.npz            (frame cache: uv, desc, fmask)
  <match_pair_path>/match_pairs.npz, rel_poses.npz   (row caches)
  <depth_path>/{i}.npy                    (u16 LiDAR depth)
  result/sfm/depth_visualize/depth_{i}.jpg  (the port's own JPEG encoder,
                                            io/jpeg.py, at cv2's defaults)
  result/sfm/after_sift_match.txt, match_pair.txt, rotations_after_L1.txt,
             camera_pose_beforeBA.{txt,ply}, camera_center_beforeBA.pcd,
             camera_pose_refine.txt, camera_pose_final.{txt,ply},
             camera_center_final.pcd, lidar_pose.txt, points.npz,
             frames.npz, structure.pcd

`init_lidar_pose` (InitLidarPose, main.cpp:372-452; JAX pipeline.py:665-830):

  result/sfm/lidar_pose.txt               (input, stage 1's lidar poses)
  result/odometry/lidar_pose_refined.txt, lidar_center_refined.pcd,
                  lidar_pose_refined.ply
  <lidar_path_undistort>/*.pcd            (undistorted clouds)
  result/odometry/lidar_pose_undis_refined.txt, lidar_center_undis_refined.pcd

`joint_optimization` (JointOptimization, main.cpp:454-522; JAX pipeline.py:833-926):

  result/sfm/frames.npz, points.npz        (input, stage 1)
  result/odometry/lidar_pose_undis_refined.txt + <lidar_path_undistort>/*.pcd,
    or lidar_pose_refined.txt + <lidar_path>  (input, stage 2)
  result/joint/camera_pose_joint.txt, lidar_pose_joint.txt, points.npz,
               camera_center_joint.pcd, lidar_center_joint.pcd,
               camera_pose_joint.ply, lidar_pose_joint.ply

`colorize_lidar_map` (ColorizeLidarMap, main.cpp:524-551; JAX pipeline.py:929-965):

  <image_path>/*.{jpg,png}                 (input, read in colour)
  <lidar_path_undistort>/*.pcd, else <lidar_path>  (input)
  result/joint/{camera,lidar}_pose_joint.txt  (input, stage 3's poses)
  result/texture/colorized_map.pcd         (x y z rgb; intensity for gray)

`joint_mvs` (JointMVS, main.cpp:553-678; JAX pipeline.py:968-1320):

  result/joint/{camera,lidar}_pose_joint.txt  (input, stage 3's poses)
  result/sfm/points.npz                    (input with mvs_neighbor_selection = 1)
  <mvs_data_path>/{depth,conf}/NNNNNN_{pho,geo,filter}.npy (u16), normal/*.npy
  result/mvs/mvs_fused.pcd
"""

from __future__ import annotations

import glob
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from scipy.spatial.transform import Rotation as ScR

from . import device as device_mod
from .config import Config
from .io import artifacts, pointcloud
from .models import lidar_odometry
from .sensors import velodyne as vd
from .utils import poses as pose_util
from .utils import visualization as viz
from .utils.timing import TimeReport

log = logging.getLogger("panovlm")

# Scans extracted per batch: bounds the (scans x 2048 x 1024) line-hypothesis
# temporaries of sensors/lidar_lines.py to a few GB.
EXTRACT_BATCH = 64


def _list_files(path, exts):
    out = []
    for e in exts:
        out += glob.glob(os.path.join(path, f"*.{e}"))
    return sorted(out)


def load_scans(cfg: Config, path: str | None = None):
    """Load + preprocess all scans of cfg.lidar_path, or of `path` (falling
    back to cfg.lidar_path when that holds no clouds), with the native
    threaded prefetcher (numpy fallback)."""
    from .native import ScanPrefetcher
    files = _list_files(path or cfg.lidar_path, ("pcd", "ply"))
    if not files and path:   # undistort dir empty/missing: raw clouds
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
    device = device_mod.resolve(device)
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


def joint_optimization(cfg: Config, tr: TimeReport | None = None, device="cuda"):
    """Camera-LiDAR joint refinement (JointOptimization, main.cpp:454-522).
    Reads stage 1's frames.npz / points.npz and stage 2's LiDAR poses: the
    undistortion round's poses with the undistorted clouds when both exist
    (main.cpp:469-472), else the raw clouds with lidar_pose_refined.txt.
    Returns (camera poses, LiDAR poses) (N, 6) numpy."""
    from .io import images
    from .models import camera_lidar as cl
    from .models import sfm as sfm_mod
    from .utils import panorama_line as pl

    device = device_mod.resolve(device)
    tr = tr or TimeReport()
    os.makedirs(cfg.joint_result_path, exist_ok=True)
    grays, names = images.load_images(cfg.image_path, cfg.scale)
    frames = artifacts.load_npz(os.path.join(cfg.sfm_result_path, "frames.npz"))
    tracks = artifacts.read_point_tracks(os.path.join(cfg.sfm_result_path, "points.npz"))
    undis_pose = os.path.join(cfg.odo_result_path, "lidar_pose_undis_refined.txt")
    use_undis = bool(os.path.exists(undis_pose) and cfg.lidar_path_undistort
                     and os.path.isdir(cfg.lidar_path_undistort)
                     and _list_files(cfg.lidar_path_undistort, ("pcd", "ply")))
    scans, lidar_valid, lidar_names = load_scans(
        cfg, path=cfg.lidar_path_undistort if use_undis else None)
    jcfg = cl.JointConfig(
        num_iteration_joint=cfg.num_iteration_joint,
        neighbor_size_joint=cfg.neighbor_size_joint,
        camera_weight=cfg.camera_weight, lidar_weight=cfg.lidar_weight,
        camera_lidar_weight=cfg.camera_lidar_weight,
        angle_residual=cfg.angle_residual, normalize_distance=cfg.normalize_distance,
        use_image_track=cfg.use_image_track, use_lidar_track=cfg.use_lidar_track,
        use_track_associate=cfg.use_track_associate,
        min_track_length=cfg.min_track_length)
    with tr.phase("extract image lines"):
        line_mask = images.load_mask(cfg.mask_path, *grays[0].shape[:2])
        # the descriptors serve the image-line matching alone
        arc_batch = {k: torch.from_numpy(v).to(device) for k, v in
                     pl.extract_panorama_lines_batch(
                         grays, mask=line_mask, num_threads=cfg.num_threads,
                         with_descriptors=cfg.use_image_track, device=device).items()}
    with tr.phase("extract lidar features"):
        lidar_batch = extract_all_features(scans, _scan_cap(scans), cfg, device)
    with tr.phase("load poses"):
        odo = undis_pose if use_undis else os.path.join(cfg.odo_result_path,
                                                        "lidar_pose_refined.txt")
        R_wl, t_wl, _, pose_ok = artifacts.read_pose_t(odo)
        lidar_poses0 = pose_util.world_to_params(
            np.where(pose_ok[:, None, None], R_wl, np.eye(3)),
            np.where(pose_ok[:, None], t_wl, 0.0))
        cam_poses0 = frames["poses"]
    with tr.phase("joint optimize"):
        def on_dev(a):
            return torch.as_tensor(np.asarray(a), device=device)
        # baseline-ratio structure filter (EstimateStructure ->
        # FilterTracksToFar(8), CameraLidarOptimizer.cpp:720-729)
        point_ok = sfm_mod.filter_tracks_too_far(
            on_dev(np.asarray(cam_poses0, np.float32)), on_dev(tracks["track_img"]),
            on_dev(tracks["track_mask"]), on_dev(np.asarray(tracks["points"], np.float32)),
            on_dev(tracks["point_ok"]), 8.0)
        cam_t, lidar_t, points_t, _ = cl.joint_optimize(
            arc_batch, lidar_batch, cam_poses0, lidar_poses0, tracks["track_img"],
            tracks["track_feat"], tracks["track_mask"], frames["bearings"],
            tracks["points"], point_ok, jcfg,
            lidar_valid=lidar_valid & pose_ok[:len(lidar_valid)], grays=grays, tr=tr)
        cam_poses, lidar_poses = cam_t.cpu().numpy(), lidar_t.cpu().numpy()
        points, point_ok = points_t.cpu().numpy(), point_ok.cpu().numpy()
    with tr.phase("export"):
        R_c, t_c = pose_util.params_to_world(cam_poses)
        artifacts.export_pose_t(os.path.join(cfg.joint_result_path, "camera_pose_joint.txt"),
                                R_c, t_c, names)
        R_l, t_l = pose_util.params_to_world(lidar_poses)
        artifacts.export_pose_t(os.path.join(cfg.joint_result_path, "lidar_pose_joint.txt"),
                                R_l, t_l, lidar_names)
        artifacts.export_point_tracks(
            os.path.join(cfg.joint_result_path, "points.npz"), tracks["track_img"],
            tracks["track_feat"], tracks["track_mask"], points, point_ok)
        for kind, poses in (("camera", cam_poses), ("lidar", lidar_poses)):
            viz.camera_centers_pcd(
                os.path.join(cfg.joint_result_path, f"{kind}_center_joint.pcd"), poses)
            viz.camera_pose_ply(
                os.path.join(cfg.joint_result_path, f"{kind}_pose_joint.ply"), poses)
    return cam_poses, lidar_poses


def colorize_lidar_map(cfg: Config, tr: TimeReport | None = None, device="cuda"):
    """ColorizeLidarMap (main.cpp:524-551): every scan coloured from its
    nearest camera at the joint poses, the scans fused in a 0.04 m voxel
    grid. The reference's phases "colorize" and "export", plus "load images"
    (the colour panoramas, decoded on threads), which the reference leaves
    in its unlabelled time; reading the scans and poses stays unlabelled,
    as there. Returns (fused points (N*P,3), their mask) numpy."""
    from .io import images
    from .models import texture

    device = device_mod.resolve(device)
    tr = tr or TimeReport()
    os.makedirs(cfg.texture_result_path, exist_ok=True)
    with tr.phase("load images"):
        colors, _ = images.load_images_u8(cfg.image_path, cfg.scale, color=True)
    # the joint poses belong to the undistorted clouds when the undistortion
    # round ran (main.cpp:432-434); load_scans falls back to the raw ones
    scans, valid, _ = load_scans(cfg, path=cfg.lidar_path_undistort)
    R_l, t_l, _, l_ok = artifacts.read_pose_t(
        os.path.join(cfg.joint_result_path, "lidar_pose_joint.txt"))
    # the camera validity flags are not read, as in the reference (ROADMAP)
    R_c, t_c, _, _ = artifacts.read_pose_t(
        os.path.join(cfg.joint_result_path, "camera_pose_joint.txt"))
    lidar_params = pose_util.world_to_params(R_l, t_l)
    cam_params = pose_util.world_to_params(R_c, t_c)
    cap = _scan_cap(scans)
    pts = np.zeros((len(scans), cap, 3), np.float32)
    msk = np.zeros((len(scans), cap), bool)
    for i, s in enumerate(scans):
        p, m = vd.pad_points(s, cap)
        pts[i], msk[i] = p, m & valid[i] & l_ok[i]
    with tr.phase("colorize"):
        pw, col, ok = texture.colorize_lidar_map(pts, msk, lidar_params, np.stack(colors),
                                                 cam_params, device=device)
        fused, fmask, fcol = (t.cpu().numpy() for t in texture.fuse_cloud(pw, col, ok))
    with tr.phase("export"):
        rgb = np.clip(fcol[fmask] * 255, 0, 255)
        pointcloud.write_pcd(
            os.path.join(cfg.texture_result_path, "colorized_map.pcd"), fused[fmask],
            rgb=rgb if rgb.shape[1] == 3 else None,
            intensity=None if rgb.shape[1] == 3 else rgb[:, 0] / 255)
    return fused, fmask


def _pose_T(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def joint_mvs(cfg: Config, tr: TimeReport | None = None, device="cuda"):
    """Panoramic PatchMatch MVS (JointMVS, main.cpp:553-678), one frame per
    PatchMatch call. Returns (depths, confs) (N,H,W) numpy after segment
    removal and gap filling, as the JAX stage does."""
    from .io import images
    from .models import mvs as mvs_mod
    from .ops import spherical
    from .ops.patchmatch import PatchMatchConfig, check_config
    from .utils.depth_completion import compute_depth_images
    from .utils.membudget import assert_host_budget

    device = device_mod.resolve(device)
    tr = tr or TimeReport()
    mcfg = mvs_mod.MVSConfig(
        pm=PatchMatchConfig(
            ncc_half_window=cfg.ncc_half_window, ncc_step=cfg.ncc_step,
            min_depth=cfg.min_depth, max_depth=cfg.max_depth,
            sweep_slices=cfg.mvs_sweep_slices),
        n_iterations=cfg.mvs_num_iterations,
        propagate=cfg.propagate_strategy,
        keep_lidar_constant=cfg.keep_lidar_constant,
        mvs_use_geometric=cfg.mvs_use_geometric,
        depth_diff_threshold=cfg.depth_diff_threshold,
        min_segment=cfg.min_segment)
    check_config(mcfg.pm)
    for d in (cfg.mvs_result_path, cfg.mvs_depth_path, cfg.mvs_normal_path,
              cfg.mvs_conf_path):
        os.makedirs(d, exist_ok=True)
    grays, names = images.load_images(cfg.image_path, cfg.scale)
    n = len(grays)
    H, W = grays[0].shape
    assert_host_budget("joint_mvs", {
        "grays": ((n, H, W), np.float32),
        "depths+confs": ((2, n, H, W), np.float32),
        "normals": ((n, H, W, 3), np.float32),
        "filtered d+c": ((2, n, H, W), np.float32),
        "colors (fuse)": ((n, H, W, 3), np.float32),
    })
    R_c, t_c, _, c_ok = artifacts.read_pose_t(
        os.path.join(cfg.joint_result_path, "camera_pose_joint.txt"))
    poses = pose_util.world_to_params(R_c, t_c)
    joint_lidar = os.path.join(cfg.joint_result_path, "lidar_pose_joint.txt")

    with tr.phase("refine camera pose"):
        # MVS::RefineCameraPose (mvs/MVS.cpp:383-428)
        refine_txt = os.path.join(cfg.mvs_result_path, "camera_pose_after_refine.txt")
        R_l = t_l = None
        if os.path.exists(refine_txt):
            # stage-internal resume: re-derive the rigid lidar move from the
            # saved refine result
            R_c2, t_c2, _, _ = artifacts.read_pose_t(refine_txt)
            if os.path.exists(joint_lidar):
                R_l, t_l, _, _ = artifacts.read_pose_t(joint_lidar)
                for i in range(min(len(R_l), n)):
                    T_wl2 = (_pose_T(R_c2[i], t_c2[i]) @ np.linalg.inv(_pose_T(R_c[i], t_c[i]))
                             @ _pose_T(R_l[i], t_l[i]))
                    R_l[i], t_l[i] = T_wl2[:3, :3], T_wl2[:3, 3]
            R_c, t_c = R_c2, t_c2
            poses = pose_util.world_to_params(R_c, t_c)
        elif (os.path.exists(os.path.join(cfg.sfm_result_path, "frames.npz"))
              and os.path.exists(os.path.join(cfg.sfm_result_path, "points.npz"))):
            # global BA with the pixel residual over the SfM tracks, then the
            # joint LiDAR poses follow their camera rigidly
            from .models import sfm as sfm_mod
            frames = artifacts.load_npz(os.path.join(cfg.sfm_result_path, "frames.npz"))
            tracks = artifacts.read_point_tracks(os.path.join(cfg.sfm_result_path, "points.npz"))
            T_cl_list = None
            if os.path.exists(joint_lidar):
                R_l, t_l, _, _ = artifacts.read_pose_t(joint_lidar)
                n_cl = min(len(R_l), n)
                T_cl_list = [np.linalg.inv(_pose_T(R_c[i], t_c[i])) @ _pose_T(R_l[i], t_l[i])
                             for i in range(n_cl)]
            poses, _, _ = sfm_mod.global_ba(
                poses, tracks["points"], tracks["track_img"], tracks["track_feat"],
                tracks["track_mask"], frames["bearings"], tracks["point_ok"], c_ok,
                sfm_mod.SfMConfig(), residual="pixel", uv=frames["uv"], rows=H, cols=W,
                device=device)
            R_c, t_c = pose_util.params_to_world(poses)
            for i, T_cl in enumerate(T_cl_list or []):
                T_wl = _pose_T(R_c[i], t_c[i]) @ T_cl
                R_l[i], t_l[i] = T_wl[:3, :3], T_wl[:3, 3]
            artifacts.export_pose_t(refine_txt, R_c, t_c, names)

    nei_table = mvs_mod.select_neighbor_views(poses, mcfg.n_neighbors, c_ok)
    if cfg.mvs_neighbor_selection == 1:  # SFM_POINTS (MVS.h:34)
        points_npz = os.path.join(cfg.sfm_result_path, "points.npz")
        if os.path.exists(points_npz):
            tr_pts = artifacts.read_point_tracks(points_npz)
            sfm_table = mvs_mod.select_neighbor_sfm(
                poses, tr_pts["points"], tr_pts["track_img"],
                tr_pts["track_mask"], mcfg.n_neighbors)
            # rows short on co-visibility fall back to their KNN picks
            nei_table = np.where(sfm_table >= 0, sfm_table, nei_table)
        else:
            log.warning("SFM_POINTS neighbor selection requested but %s "
                        "missing; using KNN", points_npz)
    # pass-level resume: every frame has final-pass depth + conf artifacts
    pass_suffix = "geo" if cfg.mvs_use_geometric else "pho"
    resume_pass = n > 0 and all(
        os.path.exists(os.path.join(p, f"{i:06d}_{pass_suffix}.npy"))
        for i in range(n) for p in (cfg.mvs_depth_path, cfg.mvs_conf_path))
    if resume_pass:
        log.info("MVS resume: all %d _%s depth/conf artifacts present; "
                 "skipping PatchMatch passes", n, pass_suffix)

    with tr.phase("lidar depth init"):
        lidar_depths = [None] * n
        if cfg.mvs_use_lidar and not resume_pass:
            scans, _, _ = load_scans(cfg, path=cfg.lidar_path_undistort)
            if R_l is None:  # no refine round: the joint lidar poses
                R_l, t_l, _, _ = artifacts.read_pose_t(joint_lidar)
            scap = _scan_cap(scans)
            # frame i <-> scan i, with T_cl = T_wc^-1 T_wl (mvs/MVS.cpp:502-512);
            # a trailing frame without a scan takes the last scan
            js = [min(i, len(scans) - 1) for i in range(n)]
            pms = [vd.pad_points(scans[j], scap) for j in js]
            Ts = np.stack([np.linalg.inv(_pose_T(R_c[i], t_c[i])) @ _pose_T(R_l[j], t_l[j])
                           for i, j in enumerate(js)])
            dense = compute_depth_images(
                torch.from_numpy(np.stack([p for p, _ in pms])).to(device),
                torch.from_numpy(np.stack([m for _, m in pms])).to(device),
                torch.from_numpy(Ts.astype(np.float32)).to(device), H, W,
                max_depth=cfg.max_depth)
            lidar_depths = list(dense.cpu().numpy())

    if cfg.mvs_fit_sweep_range and lidar_depths[0] is not None:
        # one global fit, on every 4th texel of every frame
        pm_fit = mvs_mod.fit_sweep_range(mcfg.pm, np.stack([d[::4, ::4] for d in lidar_depths]))
        if pm_fit is not mcfg.pm:
            log.info("sweep range fit: [%.2f, %.2f] m -> [%.2f, %.2f] m, %d -> %d slices",
                     mcfg.pm.min_depth, mcfg.pm.max_depth, pm_fit.min_depth,
                     pm_fit.max_depth, mcfg.pm.sweep_slices, pm_fit.sweep_slices)
            mcfg = mcfg._replace(pm=pm_fit)

    depths = np.zeros((n, H, W), np.float32)
    normals = np.zeros((n, H, W, 3), np.float32)
    confs = np.zeros((n, H, W), np.float32)
    rays = spherical.pixel_ray_grid(H, W, device)

    def on_device(a):
        return torch.as_tensor(np.asarray(a), device=device)

    def run_pass(init_for, nei_depths, seed, suffix):
        """One PatchMatch pass over every frame, each frame's artifacts
        written as it finishes; frames whose artifacts exist are read back
        instead (frame-level resume)."""
        n_resumed = 0
        for i in range(n):
            paths = (os.path.join(cfg.mvs_depth_path, f"{i:06d}_{suffix}.npy"),
                     os.path.join(cfg.mvs_conf_path, f"{i:06d}_{suffix}.npy"),
                     os.path.join(cfg.mvs_normal_path, f"{i:06d}_{suffix}.npy"))
            if all(os.path.exists(p) for p in paths):
                depths[i] = artifacts.read_depth_u16(paths[0])
                confs[i] = artifacts.read_conf_u16(paths[1])
                normals[i] = np.load(paths[2])
                n_resumed += 1
                continue
            nei = nei_table[i]
            gen = mvs_mod.frame_generator(seed, i, device)
            d0, n0, fixed = init_for(i, gen)
            R_nr, t_nr = mvs_mod.relative_to_neighbors(poses, i, nei, device)
            d, nm, cf = mvs_mod.estimate_depth_map(
                on_device(grays[i]), on_device(np.stack([grays[j] for j in nei])),
                rays, R_nr, t_nr, d0, n0, fixed, mcfg,
                None if nei_depths is None else on_device(nei_depths[nei]), gen)
            depths[i], normals[i], confs[i] = (x.cpu().numpy() for x in (d, nm, cf))
            artifacts.export_depth_u16(paths[0], depths[i])
            artifacts.export_conf_u16(paths[1], confs[i])
            np.save(paths[2], normals[i])
        if n_resumed:
            log.info("mvs pass %s: resumed %d frames from per-frame artifacts",
                     suffix, n_resumed)

    if resume_pass:
        with tr.phase("load cached depth maps"):
            for i in range(n):
                depths[i] = artifacts.read_depth_u16(os.path.join(
                    cfg.mvs_depth_path, f"{i:06d}_{pass_suffix}.npy"))
                confs[i] = artifacts.read_conf_u16(os.path.join(
                    cfg.mvs_conf_path, f"{i:06d}_{pass_suffix}.npy"))
    else:
        with tr.phase("photometric pass"):
            def pho_init(i, gen):
                lidar = None if lidar_depths[i] is None else on_device(lidar_depths[i])
                return mvs_mod.init_depth_normal(rays, lidar, mcfg, gen=gen)
            run_pass(pho_init, None, seed=0, suffix="pho")
        if cfg.mvs_use_geometric:
            with tr.phase("geometric pass"):
                depths_pho, normals_pho = depths.copy(), normals.copy()
                unfixed = torch.zeros((H, W), dtype=torch.bool, device=device)
                run_pass(lambda i, gen: (on_device(depths_pho[i]),
                                         on_device(normals_pho[i]), unfixed),
                         depths_pho, seed=100, suffix="geo")

    with tr.phase("post + filter"):
        mask = images.load_mask(cfg.mask_path, H, W)
        if mask is not None:     # masked pixels get no depth (main.cpp:610)
            depths *= mask[None].astype(np.float32)
        for i in range(n):
            d = mvs_mod.remove_small_segments(on_device(depths[i]),
                                              cfg.depth_diff_threshold, cfg.min_segment)
            depths[i] = mvs_mod.gap_interpolation(d).cpu().numpy()
        fd, _ = mvs_mod.filter_depth_maps(depths, confs, poses, nei_table, mcfg, device)
        for i in range(n):
            artifacts.export_depth_u16(
                os.path.join(cfg.mvs_depth_path, f"{i:06d}_filter.npy"), fd[i])
    with tr.phase("fuse + export"):
        colors, _ = images.load_images(cfg.image_path, cfg.scale, color=True)
        pts, cols = mvs_mod.fuse_depth_maps(fd, np.stack(colors), poses, device=device)
        pointcloud.write_pcd(os.path.join(cfg.mvs_result_path, "mvs_fused.pcd"),
                             pts, rgb=np.clip(cols * 255, 0, 255))
    return depths, confs


# ----------------------------------------------------------------------------
# init_camera_pose
# ----------------------------------------------------------------------------

def _sfm_config(cfg: Config, cap: int):
    from .models import sfm as sfm_mod
    return sfm_mod.SfMConfig(
        num_sift=cap, sift_match_dist_threshold=cfg.sift_match_dist_threshold,
        sift_match_num_threshold=cfg.sift_match_num_threshold,
        triangulate_angle_threshold=cfg.triangulate_angle_threshold,
        upper_scale_ratio=cfg.upper_scale_ratio,
        lower_scale_ratio=cfg.lower_scale_ratio)


def _match_pairs_cached(cfg: Config, scfg, cap: int, desc, fmask, pi, pj):
    """Row-based match-pair cache (main.cpp:194-248; JAX pipeline.py:168-254):
    rows of <match_pair_path>/match_pairs.npz whose (i, j) is proposed are
    reused, the others matched on desc/fmask's device (checkpointed every
    1024 rows), and cached rows flagged `extra` (pair surgery) appended.
    Returns (pi, pj, matches) with numpy matches idx (P,K,2), mask (P,K),
    pair_ok (P,)."""
    from .models import sfm as sfm_mod
    mcache = os.path.join(cfg.match_pair_path, "match_pairs.npz") if cfg.match_pair_path else ""
    K = min(int(scfg.max_matches), cap)
    mc = artifacts.load_npz_or_none(mcache) if mcache else None
    if mc is not None and (int(mc["num_sift"]) != cap or mc["idx"].shape[1] != K
                           or mc["idx"].shape[0] != mc["pi"].shape[0]):
        log.info("cached match pairs are stale, re-matching")
        mc = None
    cpi = mc["pi"] if mc is not None else np.zeros((0,), np.int32)
    cpj = mc["pj"] if mc is not None else np.zeros((0,), np.int32)
    rowmap = {(int(a), int(b)): r for r, (a, b) in enumerate(zip(cpi, cpj))}
    cextra = (mc["extra"].astype(bool) if mc is not None and "extra" in mc
              else np.zeros(len(cpi), bool))
    gen = set(zip(pi.tolist(), pj.tolist()))
    keep_extra = [r for r in range(len(cpi))
                  if cextra[r] and (int(cpi[r]), int(cpj[r])) not in gen]
    pi = np.concatenate([pi, cpi[keep_extra].astype(pi.dtype)])
    pj = np.concatenate([pj, cpj[keep_extra].astype(pj.dtype)])
    hit = np.asarray([rowmap.get((int(a), int(b)), -1) for a, b in zip(pi, pj)], np.int64)
    have = hit >= 0
    P = len(pi)
    idx = np.zeros((P, K, 2), np.int32)
    msk = np.zeros((P, K), bool)
    pok = np.zeros((P,), bool)
    if have.any():
        idx[have] = mc["idx"][hit[have]]
        msk[have] = mc["mask"][hit[have]]
        pok[have] = mc["pair_ok"][hit[have]]
    miss = np.nonzero(~have)[0]
    extra = np.asarray([(int(a), int(b)) not in gen for a, b in zip(pi, pj)], bool)

    def _save(done_mask):
        if not mcache:
            return
        os.makedirs(cfg.match_pair_path, exist_ok=True)
        artifacts.save_npz(mcache, pi=pi[done_mask], pj=pj[done_mask], num_sift=cap,
                           idx=idx[done_mask], mask=msk[done_mask],
                           pair_ok=pok[done_mask], extra=extra[done_mask])

    if len(miss):
        if len(cpi):
            log.info("match-pair cache: %d/%d rows reused, %d re-matched",
                     int(have.sum()), P, len(miss))
        done = have.copy()
        save_every = 1024
        for s in range(0, len(miss), save_every):
            part = miss[s:s + save_every]
            mm = sfm_mod.match_all_pairs(desc, fmask, pi[part], pj[part], scfg)
            idx[part] = mm["idx"].cpu().numpy()
            msk[part] = mm["mask"].cpu().numpy()
            pok[part] = mm["pair_ok"].cpu().numpy()
            done[part] = True
            if s + save_every < len(miss):
                _save(done)
                log.info("match-pair cache: checkpoint %d/%d rows", int(done.sum()), P)
        _save(np.ones(P, bool))
    else:
        if len(cpi):
            log.info("Use existing match pairs in %s", cfg.match_pair_path)
        if len(keep_extra) != int(cextra.sum()) or len(pi) != len(cpi):
            _save(np.ones(P, bool))
    return pi, pj, {"idx": idx, "mask": msk, "pair_ok": pok}


def _match_row_fp(idx, mask):
    """Per-row blake2b fingerprint of a pair's (idx, mask) bytes: the key
    that invalidates a cached relative pose when its matches change."""
    import hashlib
    idx = np.ascontiguousarray(np.asarray(idx, np.int64))
    mask = np.ascontiguousarray(np.asarray(mask, bool))
    out = np.empty(len(idx), np.int64)
    for r in range(len(idx)):
        h = hashlib.blake2b(idx[r].tobytes() + mask[r].tobytes(), digest_size=8).digest()
        out[r] = np.int64(int.from_bytes(h, "little", signed=True))
    return out


def _relative_poses_cached(cfg: Config, scfg, bearings, matches, pi, pj):
    """Row cache of relative poses in <match_pair_path>/rel_poses.npz, keyed
    by (i, j, fingerprint of the pair's matches); missing rows are estimated
    on bearings' device (checkpointed every 4096 rows), their AC-RANSAC
    draws keyed by their row. Returns numpy arrays."""
    from .models import sfm as sfm_mod
    rcache = os.path.join(cfg.match_pair_path, "rel_poses.npz") if cfg.match_pair_path else ""
    fp = _match_row_fp(matches["idx"], matches["mask"])
    P = len(pi)
    rc = artifacts.load_npz_or_none(rcache) if rcache else None
    if rc is not None and rc["tri_points"].shape[1] != matches["idx"].shape[1]:
        log.info("cached relative poses are stale, re-estimating")
        rc = None
    hit = np.full(P, -1, np.int64)
    if rc is not None:
        rowmap = {(int(a), int(b), int(f)): r
                  for r, (a, b, f) in enumerate(zip(rc["pi"], rc["pj"], rc["fp"]))}
        hit = np.asarray([rowmap.get((int(a), int(b), int(f)), -1)
                          for a, b, f in zip(pi, pj, fp)], np.int64)
    have = hit >= 0
    K = matches["idx"].shape[1]
    out = {"rel_aa": np.zeros((P, 3), np.float32), "rel_t": np.zeros((P, 3), np.float32),
           "n_inliers": np.zeros((P,), np.int32), "ok": np.zeros((P,), bool),
           "tri_points": np.zeros((P, K, 3), np.float32),
           "tri_mask": np.zeros((P, K), bool)}
    if have.any():
        for k in out:
            out[k][have] = np.asarray(rc[k])[hit[have]]
    miss = np.nonzero(~have)[0]
    if len(miss):
        if have.any():
            log.info("relative-pose cache: %d/%d rows reused, %d estimated",
                     int(have.sum()), P, len(miss))

        def _save(done_rows):
            os.makedirs(cfg.match_pair_path, exist_ok=True)
            artifacts.save_npz(rcache, pi=np.asarray(pi)[done_rows],
                               pj=np.asarray(pj)[done_rows], fp=fp[done_rows],
                               **{k: v[done_rows] for k, v in out.items()})

        dev = bearings.device
        done = have.copy()
        save_every = 4096
        for s in range(0, len(miss), save_every):
            part = miss[s:s + save_every]
            rel = sfm_mod.relative_poses(
                bearings, torch.as_tensor(matches["idx"][part], device=dev),
                torch.as_tensor(matches["mask"][part], device=dev),
                np.asarray(pi)[part], np.asarray(pj)[part], scfg, keys=part)
            for k in out:
                out[k][part] = rel[k].cpu().numpy()
            done[part] = True
            if rcache and s + save_every < len(miss):
                _save(done)
                log.info("relative-pose cache: checkpoint %d/%d rows", int(done.sum()), P)
        if rcache:
            _save(np.ones(P, bool))
    elif rc is not None:
        log.info("Use existing relative poses in %s", cfg.match_pair_path)
    return out


def _read_gps(cfg: Config):
    """xyz (N, 3) of cfg.gps_path, or None when it is unset or absent."""
    if not (cfg.gps_path and os.path.exists(cfg.gps_path)):
        return None
    from .utils.gps import read_gps
    return read_gps(cfg.gps_path)[0]


def init_camera_pose(cfg: Config, tr: TimeReport | None = None, device="cuda"):
    """LiDAR-assisted global SfM (InitCameraPose, main.cpp:91-370). Returns
    (poses (N,6) [aa_cw, t_cw] numpy, frame_valid (N,))."""
    from .io import images, jpeg
    from .models import rotation_averaging as ra
    from .models import sfm as sfm_mod
    from .models import translation_averaging as ta
    from .ops import se3, spherical
    from .utils import tracks as trk
    from .utils.depth_completion import compute_depth_images
    from .utils.membudget import assert_host_budget

    device = device_mod.resolve(device)
    tr = tr or TimeReport()
    os.makedirs(cfg.sfm_result_path, exist_ok=True)
    grays_u8, names = images.load_images_u8(cfg.image_path, cfg.scale)
    grays = [g.astype(np.float32) / 255.0 for g in grays_u8]   # images.load_images
    n = len(grays)
    H, W = grays[0].shape

    with tr.phase("extract sift"):
        cap = int(cfg.num_sift)
        if cap > 16384:
            log.error("num_sift = %d exceeds the 16384 feature ceiling; capping", cap)
            cap = 16384
        assert_host_budget("init_camera_pose", {
            "grays": ((n, H, W), np.float32), "grays u8": ((n, H, W), np.uint8),
            "desc stack": ((n, cap, 128), np.float32),
            "uv+mask": ((n, cap, 3), np.float32), "depth maps": ((n, H, W), np.float32)})
        cache = os.path.join(cfg.frame_path, "frames_sift.npz") if cfg.frame_path else ""
        cached = None
        if cache and os.path.exists(cache):
            cached = artifacts.load_npz(cache)
            if len(cached["uv"]) != n or cached["uv"].shape[1] != cap:
                log.info("number of cached frames != images, re-extracting")
                cached = None
            else:
                log.info("Use existing frame data in %s", cfg.frame_path)
        if cached is not None:
            uv, desc, fmask = cached["uv"], cached["desc"], cached["fmask"]
        else:
            t0 = time.time()
            sift_mask = images.load_mask(cfg.mask_path, H, W)
            if cfg.sift_device:
                from .ops import sift_device as sd
                uv, desc, fmask = sd.extract_sift_device_batch(
                    np.stack(grays), num_features=cap, root_sift=cfg.root_sift,
                    mask=sift_mask, device=device)
            else:
                from .utils import sift as sift_mod
                # cv2's detector on the host (native/sift.cpp). The JAX stage
                # passes (g * 255).astype(uint8) of its float frames, which for
                # every 8-bit level v gives v back (float32 v / 255 * 255
                # truncates to v): the loaded bytes themselves.
                uv, desc, fmask = sift_mod.extract_sift_batch(
                    grays_u8, cap, root_sift=cfg.root_sift,
                    mask=None if sift_mask is None else sift_mask.astype(np.uint8) * 255,
                    num_threads=cfg.num_threads)
            t1 = time.time()
            if cache:
                os.makedirs(cfg.frame_path, exist_ok=True)
                artifacts.save_npz_raw(cache, uv=uv, desc=desc, fmask=fmask)
            log.info("sift: detect %.1f s, cache write %.1f s", t1 - t0, time.time() - t1)
        uv_t = torch.as_tensor(uv, device=device)
        bearings_t = spherical.image_to_cam(uv_t, H, W)
        bearings = bearings_t.cpu().numpy()

    with tr.phase("compute depth images"):
        scans, _, _ = load_scans(cfg)
        dcap = _scan_cap(scans)
        pm = [vd.pad_points(pts, dcap) for pts in scans[:n]]
        T_cl = torch.as_tensor(np.asarray(cfg.T_cl, np.float32), device=device)
        depth_maps = compute_depth_images(
            torch.from_numpy(np.stack([p for p, _ in pm])).to(device),
            torch.from_numpy(np.stack([m for _, m in pm])).to(device),
            T_cl.expand(len(pm), 4, 4), H, W, max_depth=cfg.max_depth).cpu().numpy()
        if len(depth_maps) < n:
            depth_maps = np.concatenate(
                [depth_maps, np.zeros((n - len(depth_maps), H, W), np.float32)])
        viz_dir = os.path.join(cfg.sfm_result_path, "depth_visualize")
        os.makedirs(viz_dir, exist_ok=True)

        def write_viz(i):
            color = viz.depth_to_color(depth_maps[i], cfg.max_depth_visual)   # BGR
            blend = (0.5 * color + 0.5 * (grays[i][..., None] * 255)).astype(np.uint8)
            jpeg.write_jpeg(os.path.join(viz_dir, f"depth_{i}.jpg"), blend[..., ::-1])
        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            list(pool.map(write_viz, range(n)))
        if cfg.depth_path:
            os.makedirs(cfg.depth_path, exist_ok=True)
            for i in range(n):
                artifacts.export_depth_u16(os.path.join(cfg.depth_path, f"{i}.npy"),
                                           depth_maps[i])

    scfg = _sfm_config(cfg, cap)
    desc_t = torch.as_tensor(desc, device=device)
    fmask_t = torch.as_tensor(fmask, device=device)
    with tr.phase("match pairs"):
        fm = cfg.frame_match_method
        embeddings = None
        if fm & (sfm_mod.MATCH_VLAD | sfm_mod.MATCH_GPS_VLAD) and n > 2:
            from .models import vlad
            _, _, embeddings = vlad.vlad_pairs(desc_t, fmask_t, n_centers=min(64, cap))
        gps_xyz = None
        if fm & (sfm_mod.MATCH_GPS | sfm_mod.MATCH_GPS_VLAD):
            gps_xyz = _read_gps(cfg)
            if gps_xyz is not None and len(gps_xyz) != n:
                log.error("GPS count %d != frames %d; skipping GPS pairs", len(gps_xyz), n)
                gps_xyz = None
        pi, pj = sfm_mod.init_image_pairs(n, scfg, embeddings=embeddings, gps_xyz=gps_xyz,
                                          methods=fm)
        pi, pj, matches = _match_pairs_cached(cfg, scfg, cap, desc_t, fmask_t, pi, pj)
        with open(os.path.join(cfg.sfm_result_path, "after_sift_match.txt"), "w") as f:
            for k in range(len(pi)):
                if matches["pair_ok"][k]:
                    f.write(f"{int(pi[k])} {int(pj[k])}\n")
    del desc_t
    with tr.phase("relative poses"):
        rel = _relative_poses_cached(cfg, scfg, bearings_t, matches, pi, pj)
        ok = rel["ok"] & matches["pair_ok"]
        Rm = ScR.from_rotvec(rel["rel_aa"]).as_matrix()
        with open(os.path.join(cfg.sfm_result_path, "match_pair.txt"), "w") as f:
            for k in range(len(pi)):
                if not ok[k]:
                    continue
                f.write(f"{int(pi[k])} {int(pj[k])}\n")
                f.write(" ".join(f"{Rm[k][r, c]:.9g}" if c < 3 else f"{rel['rel_t'][k][r]:.9g}"
                                 for r in range(3) for c in range(4)) + "\n")
                f.write(f"points with depth: {int(rel['n_inliers'][k])}\n")
    with tr.phase("translation scale from depth"):
        scales = sfm_mod.translation_scale_from_depth(depth_maps, H, W, rel, matches["idx"],
                                                      uv, pi, scfg)
    with tr.phase("graph filters"):
        has_scale = scales >= 0
        if not cfg.keep_pairs_no_scale:
            ok = ok & has_scale
        keep = sfm_mod.filter_by_triplet(pi, pj, rel["rel_aa"], ok)
        keep, frame_valid = sfm_mod.largest_biconnected(pi, pj, keep, n)
    with tr.phase("rotation averaging"):
        ra_keep = keep if cfg.use_all_pairs_ra else (keep & has_scale)
        aa_glob, _, _ = ra.rotation_averaging(
            n, pi[ra_keep], pj[ra_keep], rel["rel_aa"][ra_keep],
            weights=rel["n_inliers"][ra_keep], method=cfg.rotation_averaging_method,
            device=device)
        artifacts.export_pose_t(
            os.path.join(cfg.sfm_result_path, "rotations_after_L1.txt"),
            se3.exp_so3(torch.as_tensor(aa_glob)).numpy(), np.zeros((n, 3)), names)
    with tr.phase("translation averaging"):
        ta_method = {1: "softl1", 2: "l1", 3: "chordal", 4: "l2irls", 5: "bata",
                     6: "lud"}.get(cfg.translation_averaging_method, "softl1")
        ta_keep = keep if cfg.use_all_pairs_ta else (keep & has_scale)
        # the GPS hooks (SfM.cpp:1051-1052, 1218-1240): pair scales from GPS
        # distances, and the GPS translation init in place of the DLT's
        pair_scales, t_init = scales[ta_keep], None
        g_xyz = _read_gps(cfg)
        if g_xyz is not None and len(g_xyz) == n and np.isfinite(g_xyz).all():
            from .utils.gps import init_translation_gps, scale_from_gps
            pair_scales = scale_from_gps(g_xyz, pi[ta_keep], pj[ta_keep])
            if cfg.init_translation_GPS and not cfg.init_translation_DLT:
                t_init = init_translation_gps(g_xyz, aa_glob)
        t_glob, _ = ta.translation_averaging(
            aa_glob, pi[ta_keep], pj[ta_keep], rel["rel_aa"][ta_keep],
            rel["rel_t"][ta_keep], pair_scales, method=ta_method,
            upper_scale_ratio=cfg.upper_scale_ratio, lower_scale_ratio=cfg.lower_scale_ratio,
            t_init=t_init, irls_iters=cfg.num_iteration_L2IRLS, device=device)

    def export_poses(name, poses):
        R, t = pose_util.params_to_world(poses)
        R[~frame_valid] = np.eye(3)
        t[~frame_valid] = np.inf
        artifacts.export_pose_t(os.path.join(cfg.sfm_result_path, name), R, t, names)
        return R, t

    with tr.phase("structure + BA"):
        poses0 = np.concatenate([aa_glob, t_glob], axis=1).astype(np.float32)
        export_poses("camera_pose_beforeBA.txt", poses0)
        viz.camera_pose_ply(os.path.join(cfg.sfm_result_path, "camera_pose_beforeBA.ply"),
                            poses0, frame_valid)
        viz.camera_centers_pcd(os.path.join(cfg.sfm_result_path, "camera_center_beforeBA.pcd"),
                               poses0, frame_valid)
        pair_matches = [(int(pi[k]), int(pj[k]), matches["idx"][k][matches["mask"][k]])
                        for k in np.where(keep)[0]]
        timg, tfeat, tmask = trk.build_tracks(pair_matches, [cap] * n,
                                              min_length=scfg.min_track_length)

        def on_dev(a):
            return torch.as_tensor(np.array(a), device=device)
        X, x_ok = sfm_mod.estimate_structure(on_dev(poses0), bearings_t, on_dev(timg),
                                             on_dev(tfeat), on_dev(tmask), scfg)
        x_ok = x_ok.cpu().numpy()
        ba = dict(track_img=timg, track_feat=tfeat, track_mask=tmask, bearings=bearings,
                  frame_valid=frame_valid, cfg=scfg, device=device)
        poses_ba, pts_ba, _ = sfm_mod.global_ba(poses0, X.cpu().numpy(), point_ok=x_ok, **ba)
        export_poses("camera_pose_refine.txt", poses_ba)

        def pixel_filter(poses, pts, point_ok, px):
            return sfm_mod.filter_tracks_pixel_residual(
                on_dev(poses), on_dev(pts), on_dev(timg), on_dev(tfeat), on_dev(tmask),
                uv_t, on_dev(point_ok), px, H, W).cpu().numpy()
        x_ok = pixel_filter(poses_ba, pts_ba, x_ok, 40.0)
        poses_ba, pts_ba, _ = sfm_mod.global_ba(poses_ba, pts_ba, point_ok=x_ok, **ba)
        x_ok = pixel_filter(poses_ba, pts_ba, x_ok, 10.0)
        poses_fin = sfm_mod.set_to_origin(poses_ba, frame_valid)

    with tr.phase("export"):
        R_wc, t_wc = export_poses("camera_pose_final.txt", poses_fin)
        R_wl, t_wl, _ = pose_util.set_lidar_pose(
            R_wc, t_wc, frame_valid, cfg.T_cl, len(scans), cfg.data_gap_time or 0.1,
            cfg.time_offset)
        artifacts.export_pose_t(os.path.join(cfg.sfm_result_path, "lidar_pose.txt"), R_wl, t_wl)
        artifacts.export_point_tracks(os.path.join(cfg.sfm_result_path, "points.npz"),
                                      timg, tfeat, tmask, pts_ba, x_ok)
        artifacts.save_npz(os.path.join(cfg.sfm_result_path, "frames.npz"), uv=uv,
                           fmask=fmask, bearings=bearings, poses=poses_fin,
                           frame_valid=frame_valid, rows=np.asarray([H]),
                           cols=np.asarray([W]))
        viz.camera_centers_pcd(os.path.join(cfg.sfm_result_path, "camera_center_final.pcd"),
                               poses_fin, frame_valid)
        viz.camera_pose_ply(os.path.join(cfg.sfm_result_path, "camera_pose_final.ply"),
                            poses_fin, frame_valid)
        structure = os.path.join(cfg.sfm_result_path, "structure.pcd")
        if cfg.colorize_structure and x_ok.any():
            from .models import texture
            col, cok = texture.colorize_points(on_dev(pts_ba), on_dev(x_ok),
                                               on_dev(grays[0]), on_dev(poses_fin[0]))
            sel = x_ok & cok.cpu().numpy()
            pointcloud.write_pcd(structure, pts_ba[sel], intensity=col.cpu().numpy()[sel, 0])
        else:
            pointcloud.write_pcd(structure, pts_ba[x_ok])
    return poses_fin, frame_valid
