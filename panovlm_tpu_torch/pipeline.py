"""Stage functions of the port. Each reads and writes the same artifacts
as its JAX stage in panovlm_tpu/pipeline.py.

`init_lidar_pose` (InitLidarPose, main.cpp:372-452; JAX pipeline.py:665-830):

  result/sfm/lidar_pose.txt               (input, stage 1's lidar poses)
  result/odometry/lidar_pose_refined.txt, lidar_center_refined.pcd,
                  lidar_pose_refined.ply
  <lidar_path_undistort>/*.pcd            (undistorted clouds)
  result/odometry/lidar_pose_undis_refined.txt, lidar_center_undis_refined.pcd

`joint_mvs` (JointMVS, main.cpp:553-678; JAX pipeline.py:968-1320):

  result/joint/{camera,lidar}_pose_joint.txt  (input, stage 3's poses)
  <mvs_data_path>/{depth,conf}/NNNNNN_{pho,geo,filter}.npy (u16), normal/*.npy
  result/mvs/mvs_fused.pcd
"""

from __future__ import annotations

import glob
import logging
import os

import numpy as np
import torch

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

    device = torch.device(device)
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
    if cfg.mvs_neighbor_selection == 1:
        raise NotImplementedError(
            "mvs_neighbor_selection = 1 (SFM_POINTS, select_neighbor_sfm) is "
            "not ported; use 2, the camera-center KNN (ROADMAP.md)")
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
            raise NotImplementedError(
                "joint_mvs: RefineCameraPose needs models/sfm.global_ba, which is "
                f"not ported (ROADMAP.md); provide {refine_txt} or remove the SfM "
                "state (frames.npz, points.npz) to skip the refinement")

    nei_table = mvs_mod.select_neighbor_views(poses, mcfg.n_neighbors, c_ok)
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
