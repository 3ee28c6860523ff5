"""Joint panoramic MVS — the port of panovlm_tpu/models/mvs.py
(EstimateDepthMaps, MVS.cpp:81-166):

  SelectNeighborViews -> select_neighbor_views (KNN on camera centers,
                         MVS.cpp:334-381) or select_neighbor_sfm (shared
                         SfM points, MVS.cpp:248-332)
  Initialize          -> init_depth_normal (LiDAR depth + random fill,
                         MVS.cpp:496-584)
  passes              -> estimate_depth_map: one frame per call, sweep
                         volumes or exact per-plane sampling +
                         ops/patchmatch.run_patchmatch (the JAX
                         package batches frames into one program and shards
                         them over a mesh; one card runs frame by frame)
  RemoveSmallSegments -> remove_small_segments (MVS.cpp:1504)
  GapInterpolation    -> gap_interpolation (MVS.cpp:1580)
  FilterDepthMaps     -> filter_depth_maps (MVS.cpp:1794-1891), with the JAX
                         package's packed-path u16 semantics (ROADMAP F6)
  FuseDepthMaps       -> fuse_depth_maps (MVS.cpp:2168-2336)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation as ScR

from ..ops import patchmatch, se3, spherical
from ..ops.patchmatch import PatchMatchConfig
from ..sensors.velodyne import voxel_downsample


class MVSConfig(NamedTuple):
    pm: PatchMatchConfig = PatchMatchConfig()
    n_iterations: int = 4
    n_neighbors: int = 4
    propagate: int = 1                    # Propagate enum (mvs/MVS.h:38-42):
                                          # 1 checkerboard, 2 sequential
    keep_lidar_constant: bool = False     # Config.h keep_lidar_constant
    mvs_use_geometric: bool = True
    depth_diff_threshold: float = 0.01
    min_segment: int = 50
    conf_threshold: float = 0.3           # min NCC-score to keep a pixel
    filter_support: int = 2               # neighbors agreeing (Merrell)


def _rotations(poses_cw) -> np.ndarray:
    return ScR.from_rotvec(np.asarray(poses_cw, np.float64)[:, :3]).as_matrix()


def select_neighbor_views(poses_cw, n_neighbors: int, valid=None):
    """KNN neighbor view selection on camera centers (MVS.cpp:334-381).
    Returns (N, K) int32 neighbor indices, nearest first."""
    poses_cw = np.asarray(poses_cw, np.float64)
    C = -np.einsum("nji,nj->ni", _rotations(poses_cw), poses_cw[:, 3:])
    n = len(C)
    valid = np.ones(n, bool) if valid is None else np.asarray(valid)
    d = np.linalg.norm(C[:, None] - C[None], axis=-1)
    np.fill_diagonal(d, np.inf)
    d[:, ~valid] = np.inf
    return np.argsort(d, axis=1, kind="stable")[:, :n_neighbors].astype(np.int32)


def select_neighbor_sfm(poses_cw, points, track_img, track_mask,
                        n_neighbors: int, min_baseline: float = 0.0,
                        angle_threshold: float = 10.0,
                        scale_threshold: float = 1.6):
    """SFM_POINTS neighbor selection (SelectNeighborSFM, MVS.cpp:248-332):
    score every ordered view pair by shared SfM-point visibility — per
    co-visible point, an angle factor min((angle/10deg)^1.5, 1) times a
    depth-ratio factor (1 if ~equal, quadratic falloff) — then take each
    reference's top-scored neighbors whose baseline exceeds min_baseline.
    Host numpy in float64, as in the JAX package, with its float32 Rodrigues
    rotations (ops/se3.exp_so3), so that the scores and their order agree.

    points (T,3) world; track_img (T,L) view ids; track_mask (T,L).
    Returns (N, K) int32 (padded with -1 when a row lacks neighbors)."""
    poses_cw = np.asarray(poses_cw)
    n = len(poses_cw)
    R = se3.exp_so3(torch.as_tensor(poses_cw[:, :3], dtype=torch.float32)).numpy()
    C = -np.einsum("nji,nj->ni", R, poses_cw[:, 3:])
    points = np.asarray(points)
    track_img = np.asarray(track_img)
    track_mask = np.asarray(track_mask)
    L = track_img.shape[1]
    score = np.zeros((n, n), np.float64)
    # per-slot view rays and depths (T, L)
    V = points[:, None, :] - C[track_img]
    dep = np.linalg.norm(V, axis=-1)
    Vn = V / np.maximum(dep[..., None], 1e-12)

    def scale_factor(s):
        return np.where(s > scale_threshold,
                        scale_threshold ** 2 / np.maximum(s, 1e-12) ** 2,
                        np.where(s >= 1.0, 1.0, s ** 2))

    for a in range(L):
        for b in range(a + 1, L):
            m = track_mask[:, a] & track_mask[:, b]
            if not m.any():
                continue
            ia, ib = track_img[m, a], track_img[m, b]
            ang = np.degrees(np.arccos(np.clip(
                (Vn[m, a] * Vn[m, b]).sum(-1), -1.0, 1.0)))
            angf = np.minimum((ang / angle_threshold) ** 1.5, 1.0)
            s_ab = dep[m, a] / np.maximum(dep[m, b], 1e-12)
            np.add.at(score, (ia, ib), scale_factor(s_ab) * angf)
            np.add.at(score, (ib, ia), scale_factor(1.0 / s_ab) * angf)
    baseline = np.linalg.norm(C[:, None] - C[None], axis=-1)
    out = np.full((n, n_neighbors), -1, np.int32)
    for r in range(n):
        k = 0
        for j in np.argsort(-score[r]):
            if k >= n_neighbors or score[r, j] <= 0:
                break
            if baseline[r, j] > min_baseline:
                out[r, k] = j
                k += 1
    return out


def relative_to_neighbors(poses_cw, ref: int, nei_idx, device="cpu"):
    """(R_nr (V,3,3), t_nr (V,3)) float32 for each neighbor view:
    p_n = R_nr p_r + t_nr (computed in float64)."""
    poses_cw = np.asarray(poses_cw, np.float64)
    R_all = _rotations(poses_cw)
    nei = np.asarray(nei_idx)
    R_nr = R_all[nei] @ R_all[ref].T
    t_nr = poses_cw[nei, 3:] - np.einsum("vij,j->vi", R_nr, poses_cw[ref, 3:])
    return (torch.as_tensor(R_nr, dtype=torch.float32, device=device),
            torch.as_tensor(t_nr, dtype=torch.float32, device=device))


def fit_sweep_range(pm: PatchMatchConfig, depth_samples) -> PatchMatchConfig:
    """Tighten the plane-sweep depth range — and the slice count, at
    constant inverse-depth step — to the LiDAR prior's 2-98 pct span with
    0.7x / 1.3x margins (config mvs_fit_sweep_range)."""
    v = np.asarray(depth_samples).ravel()
    v = v[(v > 0) & np.isfinite(v)]
    if not pm.sweep_slices or v.size < 1024:
        return pm
    patchmatch.check_config(pm)
    lo, hi = np.percentile(v, [2.0, 98.0])
    fit_min = max(pm.min_depth, 0.7 * float(lo))
    fit_max = min(pm.max_depth, 1.3 * float(hi))
    if not fit_max > fit_min:
        return pm
    full = 1.0 / pm.min_depth - 1.0 / pm.max_depth
    part = 1.0 / fit_min - 1.0 / fit_max
    slices = int(np.clip(np.ceil(pm.sweep_slices * part / max(full, 1e-9)),
                         16, pm.sweep_slices))
    return pm._replace(min_depth=fit_min, max_depth=fit_max, sweep_slices=slices)


def init_depth_normal(rays, lidar_depth=None, cfg: MVSConfig = MVSConfig(),
                      draws=None, gen=None):
    """InitDepthNormal (MVS.cpp:496-584): LiDAR depth where available,
    log-uniform random depth elsewhere; random camera-facing normals; the
    fixed mask when keep_lidar_constant. draws: patchmatch.draw_init's
    dict, or None to draw from gen. Returns (depth, normal, fixed)."""
    if draws is None:
        draws = patchmatch.draw_init(gen, rays, cfg.pm)
    d_rand = draws["d_rand"]
    if lidar_depth is not None:
        has = lidar_depth > cfg.pm.min_depth
        depth = torch.where(has, lidar_depth, d_rand)
        fixed = has & cfg.keep_lidar_constant
    else:
        depth = d_rand
        fixed = torch.zeros(d_rand.shape, dtype=torch.bool, device=d_rand.device)
    return depth, patchmatch.random_normals(draws["n_rand"], rays), fixed


def frame_generator(seed: int, frame_id: int, device) -> torch.Generator:
    """The generator of one frame in one pass: seeded from (pass seed,
    global frame id), as the JAX package folds the frame id into the pass
    key, so a frame's draws do not depend on which frames ran before it."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) * 1_000_003 + int(frame_id))
    return g


def estimate_depth_map(gray_ref, grays_nei, rays, R_nr, t_nr, depth0, normal0,
                       fixed, cfg: MVSConfig, nei_depths=None, gen=None):
    """One frame's PatchMatch pass (EstimateDepthMapSingle,
    MVS.cpp:930-1054): u8-quantise the neighbor grays (and u16 the
    neighbor depths of the geometric pass), build the sweep volumes
    (sweep_slices > 0) or pack the views for exact sampling, run
    run_patchmatch. All tensors on one device; grays_nei (V,H,W),
    nei_depths None or (V,H,W). Returns (depth, normal, conf)."""
    patchmatch.check_config(cfg.pm)
    qs = [spherical.quantize_u8(g) for g in grays_nei]
    q_nei = torch.stack([q for q, _ in qs])
    scales = [s for _, s in qs]
    nd_q = None if nei_depths is None else spherical.quantize_u16(nei_depths, 256.0)
    if cfg.pm.sweep_slices:
        vols = patchmatch.build_sweep_volume(q_nei, scales, rays, R_nr, t_nr,
                                             cfg.pm, nd_q)
        vols, dvols = vols if nd_q is not None else (vols, None)
    else:
        vols, dvols = patchmatch.pack_views(q_nei, scales, rays, R_nr, nd_q), None
    return patchmatch.run_patchmatch(
        gray_ref, rays, depth0, normal0, fixed, R_nr, t_nr, vols, dvols,
        cfg.pm, cfg.n_iterations, cfg.propagate, gen)


def remove_small_segments(depth, depth_diff_threshold: float = 0.01,
                          min_segment: int = 50, iters: int = 48):
    """RemoveSmallSegments (MVS.cpp:1504): connected components of the depth
    map under relative continuity (|d_p - d_q| < thr * max(d_p, d_q)), by
    iters rounds of 4-neighbour min-label propagation; components smaller
    than min_segment pixels are zeroed."""
    H, W = depth.shape
    big = H * W
    valid = depth > 0

    def conn(a, b):
        return (torch.abs(a - b) < depth_diff_threshold * torch.maximum(a, b)) \
            & (a > 0) & (b > 0)

    c_left = conn(depth, torch.cat([depth[:, :1], depth[:, :-1]], dim=1))
    c_left[:, 0] = False
    c_up = conn(depth, torch.cat([depth[:1], depth[:-1]], dim=0))
    c_up[0] = False
    c_right = torch.cat([c_left[:, 1:], torch.zeros_like(c_left[:, :1])], dim=1)
    c_down = torch.cat([c_up[1:], torch.zeros_like(c_up[:1])], dim=0)
    lab = torch.where(valid, torch.arange(big, device=depth.device).view(H, W),
                      torch.full((H, W), big, device=depth.device))
    none = torch.full_like(lab, big)
    for _ in range(iters):
        l_left = torch.cat([lab[:, :1], lab[:, :-1]], dim=1)
        l_right = torch.cat([lab[:, 1:], lab[:, -1:]], dim=1)
        l_up = torch.cat([lab[:1], lab[:-1]], dim=0)
        l_down = torch.cat([lab[1:], lab[-1:]], dim=0)
        lab = torch.minimum(lab, torch.where(c_left, l_left, none))
        lab = torch.minimum(lab, torch.where(c_right, l_right, none))
        lab = torch.minimum(lab, torch.where(c_up, l_up, none))
        lab = torch.minimum(lab, torch.where(c_down, l_down, none))
        lab = torch.where(valid, lab, none)
    sizes = torch.bincount(lab.reshape(-1)[valid.reshape(-1)], minlength=big + 1)
    keep = sizes[lab] >= min_segment
    return torch.where(keep & valid, depth, torch.zeros_like(depth))


def gap_interpolation(depth, max_gap: int = 3):
    """GapInterpolation (MVS.cpp:1580): fill small holes with the mean of
    valid 4-neighbors, max_gap rounds, into empty pixels with >= 2 valid
    neighbors only (rolls wrap, as in the JAX package)."""
    d = depth
    for _ in range(max_gap):
        v = (d > 0).to(d.dtype)
        num = torch.zeros_like(d)
        den = torch.zeros_like(d)
        for dv, du in ((0, 1), (0, -1), (1, 0), (-1, 0)):
            num = num + torch.roll(d * v, (dv, du), dims=(0, 1))
            den = den + torch.roll(v, (dv, du), dims=(0, 1))
        fill = num / torch.clamp_min(den, 1.0)
        d = torch.where((d <= 0) & (den >= 2), fill, d)
    return d


def filter_depth_maps(depths, confs, poses_cw, nei_table, cfg: MVSConfig,
                      device="cpu"):
    """FilterDepthImageRefine (MVS.cpp:1794-1891) with the JAX package's
    packed-path semantics: depth and confidence are read on the u16 grid
    (depth x256, conf (c+1) x16384), the reference frame's own values too,
    and the outputs are rounded back onto it. Per reference frame, each
    neighbor's depth map is projected into the reference view; a pixel needs
    >= filter_support agreeing neighbors, conf > conf_threshold and fewer
    than V-1 occluding neighbors; supported depths are conf-weighted
    averaged. depths, confs (N,H,W) numpy. Returns numpy (depths, confs)."""
    N, H, W = depths.shape
    rays = spherical.pixel_ray_grid(H, W, device)
    dq = spherical.quantize_u16(torch.as_tensor(depths, device=device), 256.0)
    cq = spherical.quantize_u16(torch.as_tensor(confs, device=device), 16384.0, 1.0)
    thr = cfg.depth_diff_threshold
    out_d = np.zeros((N, H, W), np.float32)
    out_c = np.zeros((N, H, W), np.float32)
    nei_table = np.asarray(nei_table)
    for ref in range(N):
        nei = nei_table[ref]
        R_nr, t_nr = relative_to_neighbors(poses_cw, ref, nei, device)
        depth_ref = dq[ref] * (1.0 / 256.0)
        conf_ref = cq[ref] * (1.0 / 16384.0) - 1.0
        X = depth_ref[..., None] * rays
        support, occluded, d_imp, c_n = [], [], [], []
        for v, j in enumerate(nei):
            x_n = torch.einsum("ij,hwj->hwi", R_nr[v], X) + t_nr[v]
            d_at_n = torch.linalg.vector_norm(x_n, dim=-1)
            uv = spherical.cam_to_image(x_n, H, W)
            d_n = spherical.sample_u16(dq[j], 256.0, uv)
            c_n.append(spherical.sample_u16(cq[j], 16384.0, uv) - 1.0)
            rel = torch.abs(d_n - d_at_n) / torch.clamp_min(d_at_n, 1e-6)
            support.append((d_n > 0) & (rel < thr * 3))
            # occlusion: the neighbor sees a CLOSER surface along this ray
            occluded.append((d_n > 0) & (d_at_n > d_n * (1 + 3 * thr)))
            ratio = torch.where(d_at_n > 1e-6, d_n / d_at_n, torch.zeros_like(d_n))
            d_imp.append(depth_ref * ratio)
        support, occluded = torch.stack(support), torch.stack(occluded)
        d_imp, c_n = torch.stack(d_imp), torch.stack(c_n)
        w = torch.where(support, torch.clamp_min(c_n, 0.0) + 1e-3, torch.zeros_like(c_n))
        c_ref = torch.clamp_min(conf_ref, 0)
        d_avg = (torch.sum(w * d_imp, dim=0) + c_ref * depth_ref) \
            / torch.clamp_min(torch.sum(w, dim=0) + c_ref, 1e-6)
        ok = ((support.sum(dim=0) >= cfg.filter_support)
              & (conf_ref > cfg.conf_threshold) & (depth_ref > 0)
              & (occluded.sum(dim=0) < len(nei) - 1))
        d = torch.where(ok, d_avg, torch.zeros_like(d_avg))
        c = torch.where(ok, conf_ref, torch.full_like(conf_ref, -1.0))
        out_d[ref] = (spherical.quantize_u16(d, 256.0) / 256.0).cpu().numpy()
        out_c[ref] = (spherical.quantize_u16(c, 16384.0, 1.0) / 16384.0 - 1.0).cpu().numpy()
    return out_d, out_c


def _is_sky_color(rgb):
    """Sky-blue rejection gate (FuseDepthImages, MVS.cpp:2311-2317): HSV in
    H [100,124] (OpenCV 0-180 hue), S [43,200], V [150,255]. rgb (...,3) in
    [0,1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = mx - mn
    safe_c = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(mx == r, torch.remainder((g - b) / safe_c, 6.0),
                    torch.where(mx == g, (b - r) / safe_c + 2.0,
                                (r - g) / safe_c + 4.0))
    h = torch.where(c > 0, h * 30.0, torch.zeros_like(h))     # OpenCV hue: 0..180
    s = torch.where(mx > 0, c / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx)) * 255.0
    v = mx * 255.0
    return ((h >= 100) & (h <= 124) & (s >= 43) & (s <= 200)
            & (v >= 150) & (v <= 255))


def fuse_depth_maps(depths, colors, poses_cw, voxel: float = 0.04, device="cpu"):
    """FuseDepthImages (MVS.cpp:2168-2336): back-project every depth map to
    world, conf-free centroid voxel merge in two levels (per chunk of
    frames, then a count-weighted pass over the chunk centroids, which
    equals the global per-voxel centroid). Depth is read on the u16 grid,
    colors on the u8 grid, as in the JAX package. depths (N,H,W), colors
    (N,H,W) gray or (N,H,W,3) in [0,1], numpy. Returns numpy (points (M,3),
    colors (M,) or (M,3)); sky-blue points are dropped."""
    N, H, W = depths.shape
    rays = spherical.pixel_ray_grid(H, W, device)
    R_wc_all = torch.as_tensor(_rotations(poses_cw).transpose(0, 2, 1),
                               dtype=torch.float32, device=device)
    t_all = torch.as_tensor(np.asarray(poses_cw)[:, 3:], dtype=torch.float32,
                            device=device)
    B = max(1, min(N, (1 << 24) // (H * W)))             # ~16M px per chunk
    acc_p, acc_c, acc_n = [], [], []
    for s in range(0, N, B):
        e = min(s + B, N)
        d = spherical.quantize_u16(torch.as_tensor(depths[s:e], device=device)) / 256.0
        col = torch.clamp(torch.round(torch.as_tensor(colors[s:e], device=device,
                                                      dtype=torch.float32) * 255.0),
                          0, 255) / 255.0
        X = d[..., None] * rays
        Xw = torch.einsum("bij,bhwj->bhwi", R_wc_all[s:e], X - t_all[s:e, None, None, :])
        pts = Xw.reshape(-1, 3)
        cols = col.reshape(pts.shape[0], -1)
        msk = (d > 0).reshape(-1)
        if cols.shape[-1] == 3:
            msk = msk & ~_is_sky_color(cols)
        p, m, c, cnt = voxel_downsample(pts, msk, aux=cols, leaf=voxel,
                                        return_counts=True)
        nv = int(m.sum())
        acc_p.append(p[:nv])
        acc_c.append(c[:nv])
        acc_n.append(cnt[:nv])
    pts, cols, cnts = torch.cat(acc_p), torch.cat(acc_c), torch.cat(acc_n)
    fused, fmask, caux = voxel_downsample(
        pts, torch.ones(len(pts), dtype=torch.bool, device=device), aux=cols,
        leaf=voxel, weights=cnts)
    nv = int(fmask.sum())
    caux = caux[:nv]
    return fused[:nv].cpu().numpy(), (caux[:, 0] if caux.shape[1] == 1 else caux).cpu().numpy()
