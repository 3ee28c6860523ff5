"""Global SfM steps — the port of panovlm_tpu/models/sfm.py (sfm/SfM.{h,cpp}
of the reference), batched over image pairs on the card:

  InitImagePairs    -> init_image_pairs (exhaustive / contiguous / VLAD /
                       GPS / GPS_VLAD)
  MatchImagePairs   -> match_all_pairs (K1 at D = 128 through ops/knn.py,
                       a batch of pairs per launch)
  FilterImagePairs  -> relative_poses (AC-RANSAC -> decompose -> CheckRT ->
                       two-view chordal refinement, a chunk of pairs at once)
  SetTranslationScaleDepthMap -> translation_scale_from_depth (host numpy)
  FilterByTriplet / LargestBiconnectedGraph -> host graph code (utils/graph.py)
  EstimateStructure -> estimate_structure
  FilterTracksToFar -> filter_tracks_too_far (the joint stage's filter)
  GlobalBundleAdjustment -> global_ba (LM with the Schur tier)
  SetToOrigin -> set_to_origin

Pose convention: params [aa_cw, t_cw] (world->camera). The JAX module's TPU
staging (the 32-pair `lax.map` chunks, `_map_tracks_chunked`) is not
carried over; chunks here bound device memory only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from scipy.spatial.transform import Rotation as ScR

from ..ops import epipolar, se3, spherical, triangulate as tri_ops
from ..solver import residuals, robust
from ..solver.lm import LMOptions, ResidualBlock, solve_lm
from ..solver.two_view import two_view_refine
from ..utils import graph as graph_mod
from ..utils.gps import gps_pairs
from ..utils.sift import match_descriptors


class SfMConfig(NamedTuple):
    num_sift: int = 4096
    sift_match_dist_threshold: float = 0.6
    sift_match_num_threshold: int = 40
    pair_method: str = "contiguous"
    contiguous_window: int = 20
    ransac_hypotheses: int = 300
    min_inliers: int = 30
    triangulate_angle_threshold: float = 25.0
    translation_method: str = "softl1"
    upper_scale_ratio: float = 1.3
    lower_scale_ratio: float = 0.9
    max_matches: int = 1024
    match_max_dist_factor: float = 0.8
    ba_huber_deg: float = 4.0
    min_track_length: int = 3


MATCH_EXHAUSTIVE = 1
MATCH_CONTIGUOUS = 2
MATCH_VLAD = 4
MATCH_GPS = 8
MATCH_GPS_VLAD = 16


def init_image_pairs(n_frames: int, cfg: SfMConfig, embeddings=None, gps_xyz=None,
                     methods: int | None = None):
    """Pair proposal (InitImagePairs, sfm/SfM.cpp:49-168): the union of the
    sources in the FrameMatchMethod bitmask, or every pair for EXHAUSTIVE.
    CONTIGUOUS: the temporal window; VLAD: the max(N/40, 15) most similar
    `embeddings` per frame; GPS: each frame's 15 nearest `gps_xyz` within
    7 m; GPS_VLAD: the max(N/40, 1) most similar embeddings kept within
    20 m in GPS. A source without its input adds nothing; no pair at all
    falls back to the temporal window. Returns (pi, pj) int32, sorted."""
    if methods is None:
        methods = (MATCH_EXHAUSTIVE if cfg.pair_method == "exhaustive" else
                   MATCH_CONTIGUOUS | (MATCH_VLAD if cfg.pair_method == "vlad" else 0))
    if methods & MATCH_EXHAUSTIVE:
        pi, pj = np.triu_indices(n_frames, k=1)
        return pi.astype(np.int32), pj.astype(np.int32)

    def _contiguous():
        w = cfg.contiguous_window
        return {(i, j) for i in range(n_frames)
                for j in range(i + 1, min(i + 1 + w, n_frames))}

    def _vlad_neighbors(k):
        e = np.asarray(embeddings)
        e = e / (np.linalg.norm(e, axis=1, keepdims=True) + 1e-12)
        sim = e @ e.T
        np.fill_diagonal(sim, -np.inf)
        return [np.argsort(-sim[i])[:k] for i in range(n_frames)]

    pairs = _contiguous() if methods & MATCH_CONTIGUOUS else set()
    if methods & MATCH_VLAD and embeddings is not None:
        for i, nbrs in enumerate(_vlad_neighbors(max(n_frames // 40, 15))):
            for j in nbrs:
                if i != j:
                    pairs.add((min(i, int(j)), max(i, int(j))))
    if methods & MATCH_GPS and gps_xyz is not None:
        gi, gj = gps_pairs(gps_xyz, radius=7.0, max_per_frame=15)
        pairs |= set(zip(gi.tolist(), gj.tolist()))
    if methods & MATCH_GPS_VLAD and embeddings is not None and gps_xyz is not None:
        g = np.asarray(gps_xyz)
        for i, nbrs in enumerate(_vlad_neighbors(max(n_frames // 40, 1))):
            for j in nbrs:
                if i != j and np.linalg.norm(g[i] - g[int(j)]) <= 20.0:
                    pairs.add((min(i, int(j)), max(i, int(j))))
    if not pairs:
        pairs = _contiguous()
    ordered = sorted(pairs)
    return (np.array([p[0] for p in ordered], np.int32),
            np.array([p[1] for p in ordered], np.int32))


def match_batch(device: torch.device, n_features: int) -> int:
    """Pairs per matching launch: 16 on the card; on the CPU as many as keep
    the plain version's (B, Q, T) distances near 2^24 entries."""
    if device.type == "cuda":
        return 16
    return max(1, (1 << 24) // max(n_features * n_features, 1))


def match_all_pairs(desc, fmask, pi, pj, cfg: SfMConfig, batch: int | None = None):
    """Match every proposed pair (MatchImagePairs, SfM.cpp:229-295). desc
    (N, F, 128) float32 and fmask (N, F) on one device. Each batch gathers
    its pairs' descriptor rows once and runs both KNN searches over the
    batch. Returns dict idx (P, K, 2) int32, mask (P, K), dist (P, K),
    pair_ok (P,) on that device, K = min(max_matches, F)."""
    P, F = len(pi), desc.shape[1]
    K = min(cfg.max_matches, F)
    dev = desc.device
    batch = batch or match_batch(dev, F)
    pi_t = torch.as_tensor(np.asarray(pi, np.int64), device=dev)
    pj_t = torch.as_tensor(np.asarray(pj, np.int64), device=dev)
    outs = []
    for s in range(0, P, batch):
        a, b = pi_t[s:s + batch], pj_t[s:s + batch]
        outs.append(match_descriptors(
            desc[a], fmask[a], desc[b], fmask[b], ratio=cfg.sift_match_dist_threshold,
            max_dist_factor=cfg.match_max_dist_factor, max_matches=cfg.max_matches))
    if outs:
        out = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
    else:
        out = {"idx": torch.zeros((0, K, 2), dtype=torch.int32, device=dev),
               "mask": torch.zeros((0, K), dtype=torch.bool, device=dev),
               "dist": torch.zeros((0, K), device=dev)}
    out["pair_ok"] = out["mask"].sum(dim=1) >= cfg.sift_match_num_threshold
    return out


def pair_draws(keys, n_hyp: int, mask):
    """AC-RANSAC sample draws per pair: uniform in [0, max(n_valid, 1)) from
    a CPU torch.Generator seeded with the pair's key (its row in the full
    pair list), so a partial recompute draws what a full run draws on any
    device. Returns (P, n_hyp, 8) int64 on mask's device."""
    n_valid = mask.sum(dim=1).clamp_min(1).cpu()
    out = torch.empty((len(keys), n_hyp, epipolar.MIN_SAMPLE), dtype=torch.int64)
    for r, key in enumerate(np.asarray(keys).tolist()):
        g = torch.Generator().manual_seed(int(key))
        u = torch.rand((n_hyp, epipolar.MIN_SAMPLE), generator=g)
        nv = int(n_valid[r])
        out[r] = torch.clamp_max((u * nv).long(), nv - 1)
    return out.to(mask.device)


def relative_pose_chunk(device: torch.device) -> int:
    return 256 if device.type == "cuda" else 16


def relative_poses(bearings, matches_idx, matches_mask, pi, pj, cfg: SfMConfig,
                   keys=None, draws=None):
    """Relative pose per pair (FilterImagePairs, SfM.cpp:298-480): AC-RANSAC
    essential -> decompose -> CheckRT best-of-4 -> two-view chordal
    refinement (pose 1 fixed), |t| renormalized. bearings (N, F, 3),
    matches (P, K, 2) / (P, K) tensors on one device. keys: the pairs' rows
    for `pair_draws` (default 0..P-1); draws: (P, H, 8) sample indices,
    overriding keys. Returns dict of tensors rel_aa (P,3), rel_t (P,3)
    unit, n_inliers (P,), ok (P,), tri_points (P,K,3) in frame-i
    coordinates, tri_mask (P,K)."""
    dev = bearings.device
    P = len(pi)
    keys = np.arange(P) if keys is None else np.asarray(keys)
    pi_t = torch.as_tensor(np.asarray(pi, np.int64), device=dev)
    pj_t = torch.as_tensor(np.asarray(pj, np.int64), device=dev)
    huber = float(np.radians(cfg.ba_huber_deg))
    chunk = relative_pose_chunk(dev)
    outs = []
    for s in range(0, P, chunk):
        sl = slice(s, s + chunk)
        midx = matches_idx[sl].long()
        mmask = matches_mask[sl]
        b1 = bearings[pi_t[sl][:, None], midx[..., 0]]
        b2 = bearings[pj_t[sl][:, None], midx[..., 1]]
        dr = (draws[sl] if draws is not None
              else pair_draws(keys[sl], cfg.ransac_hypotheses, mmask))
        ransac = epipolar.find_essential_acransac(b1, b2, mmask, dr)
        pose = epipolar.best_pose_from_essential(ransac["E"], b1, b2, ransac["inliers"])
        n_inl = torch.sum(pose["good"], dim=1)
        pose0 = torch.cat([se3.log_so3(pose["R_21"]), pose["t_21"]], dim=1)
        pose_tv, pts_tv, _ = two_view_refine(pose0, pose["points"], b1, b2, pose["good"],
                                             huber, max_iters=10)
        t = pose_tv[:, 3:]
        t_norm = torch.linalg.vector_norm(t, dim=1) + 1e-12
        outs.append({"rel_aa": pose_tv[:, :3], "rel_t": t / t_norm[:, None],
                     "n_inliers": n_inl.to(torch.int32),
                     "ok": ransac["ok"] & (n_inl >= cfg.min_inliers),
                     "tri_points": pts_tv / t_norm[:, None, None],
                     "tri_mask": pose["good"]})
    K = matches_idx.shape[1]
    if not outs:
        return {"rel_aa": torch.zeros((0, 3), device=dev),
                "rel_t": torch.zeros((0, 3), device=dev),
                "n_inliers": torch.zeros(0, dtype=torch.int32, device=dev),
                "ok": torch.zeros(0, dtype=torch.bool, device=dev),
                "tri_points": torch.zeros((0, K, 3), device=dev),
                "tri_mask": torch.zeros((0, K), dtype=torch.bool, device=dev)}
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def translation_scale_from_depth(depth_maps, frame_rows, frame_cols, rel,
                                 matches_idx, uv, pi, cfg: SfMConfig,
                                 min_votes: int = 10):
    """Metric scale per pair from the LiDAR depth panoramas
    (SetTranslationScaleDepthMap, SfM.cpp:487-679): robust median of
    lidar / triangulated depth over the inliers whose pixel has locally
    smooth depth, after MAD filtering. numpy in, (P,) out, -1 where
    undetermined."""
    from scipy.ndimage import grey_dilation, grey_erosion
    tri = np.asarray(rel["tri_points"])
    tmask = np.asarray(rel["tri_mask"])
    midx = np.asarray(matches_idx)
    dm = np.asarray(depth_maps)
    H, W = dm.shape[1:]
    local_max = np.stack([grey_dilation(d, size=3) for d in dm])
    local_min = np.stack([grey_erosion(np.where(d > 0, d, np.inf), size=3) for d in dm])
    smooth = (local_max - local_min) < 0.1 * np.maximum(dm, 1e-6)
    scales = np.full(len(pi), -1.0, np.float32)
    for p in range(len(pi)):
        if not tmask[p].any():
            continue
        i = int(pi[p])
        uv_i = np.asarray(uv[i])[midx[p, :, 0]]
        d_tri = np.linalg.norm(tri[p], axis=1)
        px = np.clip(uv_i[:, 0].astype(int), 0, W - 1)
        py = np.clip(uv_i[:, 1].astype(int), 0, H - 1)
        d_lidar = dm[i][py, px]
        ok = tmask[p] & (d_lidar > 0.1) & (d_tri > 1e-6) & smooth[i][py, px]
        if ok.sum() < min_votes:
            continue
        ratio = d_lidar[ok] / d_tri[ok]
        med = np.median(ratio)
        mad = np.median(np.abs(ratio - med)) + 1e-9
        inl = np.abs(ratio - med) < 3 * 1.4826 * mad
        if inl.sum() < min_votes:
            continue
        scales[p] = float(np.median(ratio[inl]))
    return scales


def filter_by_triplet(pi, pj, rel_aa, ok, angle_threshold_deg: float = 5.0):
    """Triplet rotation-consistency filter (FilterByTriplet,
    SfM.cpp:705-778): a pair survives if it lies on a triangle whose
    composed rotation is within the threshold of identity. Edges and common
    neighbours are visited in the JAX module's (networkx) order."""
    g = graph_mod.Graph()
    edge_of = {}
    for k in range(len(pi)):
        if not ok[k]:
            continue
        g.add_edge(int(pi[k]), int(pj[k]))
        edge_of[(int(pi[k]), int(pj[k]))] = k
    R = ScR.from_rotvec(np.asarray(rel_aa)).as_matrix()

    def rel_R(a, b):
        return R[edge_of[(a, b)]] if (a, b) in edge_of else R[edge_of[(b, a)]].T

    keep = np.zeros(len(pi), bool)
    for a, b in g.edges():
        for c in set(g.adj[a]) & set(g.adj[b]):
            cyc = rel_R(a, b) @ rel_R(c, a) @ rel_R(b, c)
            if np.degrees(np.linalg.norm(ScR.from_matrix(cyc).as_rotvec())) < angle_threshold_deg:
                for e in ((a, b), (min(c, a), max(c, a)), (min(b, c), max(b, c))):
                    if e in edge_of:
                        keep[edge_of[e]] = True
                break
    return keep & np.asarray(ok)


def largest_biconnected(pi, pj, ok, n_frames):
    """Largest bridge-free component (LargestBiconnectedGraph,
    SfM.cpp:780-799): remove the bridges, keep the largest component (the
    first in node order on ties). Returns (pair keep, frame valid)."""
    g = graph_mod.Graph()
    for k in range(len(pi)):
        if ok[k]:
            g.add_edge(int(pi[k]), int(pj[k]))
    if g.number_of_edges() == 0:
        return np.zeros(len(pi), bool), np.zeros(n_frames, bool)
    g2 = g.copy()
    for u, v in graph_mod.bridges(g):
        g2.remove_edge(u, v)
    comps = sorted(graph_mod.connected_components(g2), key=len, reverse=True)
    frame_valid = np.zeros(n_frames, bool)
    for v in comps[0]:
        frame_valid[v] = True
    keep = np.array([bool(ok[k]) and frame_valid[int(pi[k])] and frame_valid[int(pj[k])]
                     for k in range(len(pi))], bool)
    return keep, frame_valid


def _track_chunks(T: int, chunk: int):
    for s in range(0, T, chunk):
        yield slice(s, min(s + chunk, T))


def estimate_structure(poses_cw, bearings, track_img, track_feat, track_mask,
                       cfg: SfMConfig, chunk: int = 8192):
    """TriangulateTracks (sfm/Structure.cpp:8-85): N-view triangulation with
    the viewing-angle and reprojection-angle tests. poses (N,6), bearings
    (N,F,3), tracks (T,L) tensors on one device. Returns (X (T,3), ok (T,))."""
    Xs, oks = [], []
    for sl in _track_chunks(track_img.shape[0], chunk):
        ti, tf, m = track_img[sl].long(), track_feat[sl].long(), track_mask[sl]
        b_obs = bearings[ti, tf]
        p_obs = poses_cw[ti]
        origins, dirs = tri_ops.rays_from_poses(p_obs, b_obs)
        X, ok = tri_ops.triangulate_rays(origins, dirs, m)
        ang = tri_ops.max_pairwise_ray_angle(dirs, m)
        rep = tri_ops.reprojection_angles(p_obs, b_obs, X, m)
        Xs.append(X)
        oks.append(ok & (ang <= cfg.triangulate_angle_threshold)
                   & (torch.amax(rep, dim=-1) < 5.0) & (ang > 1.0))
    if not Xs:
        return (torch.zeros((0, 3), device=bearings.device),
                torch.zeros(0, dtype=torch.bool, device=bearings.device))
    return torch.cat(Xs), torch.cat(oks)


def filter_tracks_too_far(poses_cw, track_img, track_mask, X, ok,
                          threshold: float = 8.0, chunk: int = 512):
    """FilterTracksToFar (sfm/Structure.cpp:87-119): drop points whose mean
    distance to their observing cameras exceeds threshold x the track's
    baseline (its furthest pair of camera centres). Tensors on one device;
    returns ok (T,). The pairwise centre distances use the Gram identity
    |a-b|^2 = |a|^2 + |b|^2 - 2ab on centres taken relative to each
    track's mean centre: with raw coordinates the identity cancels
    catastrophically in float32 when the baseline is small against the
    distance from the world origin. Chunked over tracks to bound the
    (chunk, L, L) Gram blocks."""
    R_cw = se3.exp_so3(poses_cw[:, :3])
    C = -torch.einsum("nji,nj->ni", R_cw, poses_cw[:, 3:])     # camera centres
    good = []
    for sl in _track_chunks(track_img.shape[0], chunk):
        m, x = track_mask[sl], X[sl]
        c_obs = C[track_img[sl].long()]                          # (c, L, 3)
        w = m.to(c_obs.dtype)
        mean_c = (torch.sum(c_obs * w[..., None], dim=1)
                  / torch.clamp_min(torch.sum(w, dim=1), 1.0)[:, None])
        c_obs = c_obs - mean_c[:, None, :]
        sq = torch.sum(c_obs * c_obs, dim=-1)                    # (c, L)
        G = torch.einsum("tla,tma->tlm", c_obs, c_obs)
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * G
        pair_ok = m[:, :, None] & m[:, None, :]
        baseline = torch.sqrt(torch.clamp_min(
            torch.amax(torch.where(pair_ok, d2, torch.zeros_like(d2)), dim=(1, 2)), 0.0))
        dist = torch.linalg.vector_norm((x - mean_c)[:, None] - c_obs, dim=-1)
        mean_d = (torch.sum(torch.where(m, dist, torch.zeros_like(dist)), dim=1)
                  / torch.clamp_min(torch.sum(m, dim=1), 1))
        good.append(mean_d <= threshold * baseline)
    if not good:
        return ok
    return ok & torch.cat(good)


def filter_tracks_pixel_residual(poses_cw, X, track_img, track_feat, track_mask,
                                 uv, ok, threshold: float, rows: int, cols: int,
                                 chunk: int = 8192):
    """FilterTracksPixelResidual (sfm/Structure.cpp:121-157): drop points
    whose projection misses any observation by more than threshold px (u
    wrapped across the seam). Tensors on one device; returns ok (T,)."""
    R_all = se3.exp_so3(poses_cw[:, :3])
    t_all = poses_cw[:, 3:]
    worst = []
    for sl in _track_chunks(track_img.shape[0], chunk):
        ti, tf, m = track_img[sl].long(), track_feat[sl].long(), track_mask[sl]
        p_c = torch.einsum("tlij,tj->tli", R_all[ti], X[sl]) + t_all[ti]
        uv_proj = spherical.cam_to_image(p_c, rows, cols)
        uv_obs = uv[ti, tf]
        du = torch.remainder(uv_proj[..., 0] - uv_obs[..., 0] + cols / 2, cols) - cols / 2
        dv = uv_proj[..., 1] - uv_obs[..., 1]
        worst.append(torch.amax(torch.where(m, du ** 2 + dv ** 2, torch.zeros_like(du)),
                                dim=1))
    if not worst:
        return ok
    return ok & (torch.cat(worst) <= threshold ** 2)


def global_ba(poses_cw, points, track_img, track_feat, track_mask, bearings,
              point_ok, frame_valid, cfg: SfMConfig, max_iters: int = 50,
              residual: str = "chordal", uv=None, rows: int = 0, cols: int = 0,
              device="cpu"):
    """SfMGlobalBA (util/Optimization.cpp:10-82): one LM problem over every
    camera pose and point, Huber(4 deg) chordal reprojection, or with
    residual="pixel" the pixel functor at (rows, cols) with uv (N,F,2) and
    Huber(4 px) (MVS::RefineCameraPose). The first valid camera is the
    gauge; invalid frames and points are fixed. Points are eliminated per
    point (the Schur tier). numpy in; returns (poses (N,6), points (T,3),
    info) numpy."""
    dev = torch.device(device)
    T, L = np.asarray(track_img).shape
    obs_t = np.repeat(np.arange(T), L)
    obs_img = np.asarray(track_img).ravel().astype(np.int64)
    obs_feat = np.asarray(track_feat).ravel().astype(np.int64)
    frame_valid = np.asarray(frame_valid, bool)
    point_ok = np.asarray(point_ok, bool)
    obs_mask = np.asarray(track_mask).ravel() & point_ok[obs_t] & frame_valid[obs_img]
    fixed_p = np.zeros((len(frame_valid), 6), bool)
    fixed_p[~frame_valid] = True
    fixed_p[int(np.argmax(frame_valid))] = True
    fixed_x = np.zeros((T, 3), bool)
    fixed_x[~point_ok] = True

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dt, device=dev)
    idx = (t(obs_img, torch.int64), t(obs_t, torch.int64))
    if residual == "pixel":
        def fn(pose, X, obs):
            return residuals.reproj_pixel(pose, X, obs, rows, cols)
        data, scale = (t(np.asarray(uv)[obs_img, obs_feat]),), 4.0
    else:
        fn = residuals.reproj_chordal
        data, scale = (t(np.asarray(bearings)[obs_img, obs_feat]),), float(np.radians(cfg.ba_huber_deg))
    block = ResidualBlock(fn, ("poses", "pts"), idx, data,
                          torch.ones(len(obs_img), device=dev), t(obs_mask, torch.bool),
                          loss=robust.HUBER, loss_scale=scale, name="reproj")
    out, info = solve_lm({"poses": t(poses_cw), "pts": t(points)}, (block,),
                         {"poses": t(fixed_p, torch.bool), "pts": t(fixed_x, torch.bool)},
                         LMOptions(max_iters=max_iters), schur="pts")
    return out["poses"].cpu().numpy(), out["pts"].cpu().numpy(), info


def set_to_origin(poses_cw, frame_valid):
    """SetToOrigin (SfM.cpp:1385-1421): the first valid camera becomes the
    world origin with identity rotation. numpy."""
    first = int(np.argmax(np.asarray(frame_valid)))
    R0 = ScR.from_rotvec(np.asarray(poses_cw)[first, :3]).as_matrix()
    t0 = np.asarray(poses_cw)[first, 3:]
    out = np.array(poses_cw, np.float64).copy()
    for i in range(len(out)):
        if not frame_valid[i]:
            continue
        R_new = ScR.from_rotvec(out[i, :3]).as_matrix() @ R0.T
        out[i, 3:] = out[i, 3:] - R_new @ t0
        out[i, :3] = ScR.from_matrix(R_new).as_rotvec()
    return out.astype(np.float32)
