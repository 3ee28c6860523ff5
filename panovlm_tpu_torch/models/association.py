"""LiDAR feature association — ported from `panovlm_tpu/models/association.py`.

Every pair of a round is associated at once: the pair list is a batch axis,
and the nearest-neighbour searches run through the KNN kernels
(`ops/knn.py`) with that batch axis as their grid's second dimension, in
place of the JAX package's `lax.map(batch_size=8)` over pairs. The pair
semantics (reference file:line in the JAX module's docstring):

  * point->line: the 5 nearest reference edge points within 0.3 m, all on
    one segment; the association is that segment's fitted line;
  * point->plane: 10-NN within 1 m of one ground class plus the nearest
    point on each of the 4 adjacent rings; plane fitted with 0.03 m
    tolerance and rejected when collinear;
  * line->line: point votes between segments, 7 deg gate, one-to-one;
  * the neighbour graph is host numpy/cKDTree code.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import geometry, se3
from ..ops.knn import RING_OFFSETS, knn, knn_ring

P2L_KNN = 5
P2L_DIST = 0.3
P2P_KNN = 10
P2P_DIST = 1.0
PLANE_TOL = 0.03
L2L_ANGLE_DEG = 7.0
L2L_MIN_VOTES = 3


def to_world(pose, pts):
    """pose = [aa_lw, t_lw] (world->lidar); p_w = R_lw^T (p_l - t_lw).
    pose (...,6), pts (...,P,3)."""
    R_lw = se3.exp_so3(pose[..., :3])
    return torch.einsum("...ji,...pj->...pi", R_lw, pts - pose[..., None, 3:])


def scan_centers(poses):
    """World positions of the scan origins: t_wl = -R_lw^T t_lw."""
    R_lw = se3.exp_so3(poses[:, :3])
    return -torch.einsum("nji,nj->ni", R_lw, poses[:, 3:])


def find_neighbors(poses, valid, k: int = 6, loop_radius: float = 2.0,
                   loop_min_gap: int = 200, n_loop: int = 2):
    """Neighbour scan graph (FindNeighbors, LidarFeatureAssociate.cpp:19-111)
    on the host: k nearest scan centres + forced temporal prev/next + up to
    n_loop loop-closure candidates per scan (centre distance < loop_radius,
    index gap > loop_min_gap). Returns (pair_r, pair_n) int32 numpy arrays
    of unique directed pairs r != n, sorted."""
    from scipy.spatial import cKDTree
    centers = scan_centers(torch.as_tensor(poses)).cpu().numpy()
    valid = np.asarray(valid)
    n = len(centers)
    vi = np.nonzero(valid)[0]
    pairs = set()
    if len(vi) >= 2:
        tree = cKDTree(centers[vi])
        kq = min(k + 1, len(vi))                  # +1: self comes back first
        dd, jj = tree.query(centers[vi], k=kq)
        dd, jj = np.atleast_2d(dd), np.atleast_2d(jj)
        balls = tree.query_ball_point(centers[vi], loop_radius)
        for a, i in enumerate(vi):
            for b in range(kq):
                j = int(vi[jj[a, b]])
                if j != i and np.isfinite(dd[a, b]):
                    pairs.add((int(i), j))
            cand = [(np.linalg.norm(centers[int(vi[b])] - centers[i]),
                     int(vi[b])) for b in balls[a]
                    if abs(int(vi[b]) - int(i)) > loop_min_gap]
            for _, j in sorted(cand)[:n_loop]:
                pairs.add((int(i), j))
    for i in vi:
        for j in (i - 1, i + 1):  # forced temporal
            if 0 <= j < n and valid[j]:
                pairs.add((int(i), int(j)))
    ordered = sorted(pairs)
    pair_r = np.array([p[0] for p in ordered], np.int32)
    pair_n = np.array([p[1] for p in ordered], np.int32)
    return pair_r, pair_n


def _take(x, idx):
    """x (M, N, ...) gathered at idx (M, ...) along axis 1."""
    M = x.shape[0]
    flat = idx.reshape(M, -1).long()
    if x.dim() == 2:
        return torch.gather(x, 1, flat).reshape(idx.shape)
    tail = x.shape[2:]
    g = torch.gather(x, 1, flat.reshape(M, -1, *([1] * len(tail))).expand(
        M, flat.shape[1], *tail))
    return g.reshape(*idx.shape, *tail)


def associate_point2line_pair(feats_r, feats_n, pose_r, pose_n,
                              dist_threshold: float = P2L_DIST):
    """Point->line for a batch of (reference, neighbour) pairs: feats_* are
    dicts of (M, ...) feature tensors, pose_* (M, 6). Returns per neighbour
    edge point (M, CAP_EDGE) association tensors."""
    er_w = to_world(pose_r, feats_r["less_sharp"]).contiguous()
    en_w = to_world(pose_n, feats_n["less_sharp"]).contiguous()
    knn_d2, idx = knn(en_w, feats_n["less_sharp_mask"].contiguous(),
                      er_w, feats_r["less_sharp_mask"].contiguous(), P2L_KNN)
    labels = _take(feats_r["point_to_segment"], idx)            # (M, Pn, 5)
    all_close = knn_d2[..., -1] <= dist_threshold ** 2
    same_seg = torch.all(labels == labels[..., :1], dim=-1) & (labels[..., 0] >= 0)
    ok = all_close & same_seg & feats_n["less_sharp_mask"]
    seg = torch.clamp_min(labels[..., 0], 0)
    ok = ok & _take(feats_r["line_mask"], seg)
    seg_n = feats_n["point_to_segment"]
    return {"mask": ok, "point": feats_n["less_sharp"],
            "line_pt": _take(feats_r["line_points"], seg),
            "line_dir": _take(feats_r["line_dirs"], seg), "seg_r": seg,
            "seg_n": torch.clamp_min(seg_n, 0), "seg_n_valid": seg_n >= 0}


def associate_point2plane_pair(feats_r, feats_n, pose_r, pose_n,
                               dist_threshold: float = P2P_DIST,
                               plane_tolerance: float = PLANE_TOL):
    """Point->plane for a batch of pairs (queries = neighbour surfFlat,
    targets = reference surfLessFlat), with the nearest point of each of
    the 4 adjacent rings added to the fit (keeps near-horizontal fits
    well-posed). Plane fitted in the reference local frame."""
    q_local = feats_n["flat"]
    q_w = to_world(pose_n, q_local).contiguous()
    t_local = feats_r["less_flat"]
    t_w = to_world(pose_r, t_local).contiguous()
    knn_d2, idx, ring_d2, ring_idx = knn_ring(
        q_w, feats_n["flat_mask"].contiguous(), t_w,
        feats_r["less_flat_mask"].contiguous(),
        feats_n["flat_row"].contiguous(), feats_r["less_flat_row"].contiguous(),
        P2P_KNN, RING_OFFSETS)
    idx_ext = torch.cat([idx, ring_idx], dim=-1)                 # (M, Q, 14)
    d2_ext = torch.cat([knn_d2, ring_d2], dim=-1)
    close = knn_d2[..., -1] <= dist_threshold ** 2
    t_g = _take(feats_r["less_flat_ground"], idx)
    same_class = torch.all(t_g == feats_n["flat_ground"][..., None], dim=-1)
    nn_local = _take(t_local, idx_ext)                           # (M, Q, 14, 3)
    fit = geometry.fit_plane_lsq(nn_local, d2_ext <= dist_threshold ** 2,
                                 tolerance=plane_tolerance)
    ev = fit["eigvals"]
    collinear = ev[..., 1] < 2.7e-3 * ev[..., 2]
    ok = close & same_class & fit["ok"] & ~collinear & feats_n["flat_mask"]
    plane = torch.cat([fit["normal"], fit["d"][..., None]], dim=-1)
    return {"mask": ok, "point": q_local, "plane": plane}


def associate_line2line_pair(p2l, feats_r, feats_n,
                             angle_deg: float = L2L_ANGLE_DEG,
                             min_votes: int = L2L_MIN_VOTES):
    """Line->line for a batch of pairs via the point-vote matrix
    (FindAssociations, LidarFeatureAssociate.cpp:120-197): each point->line
    association votes (its segment in n) -> (matched segment in r); a match
    is one-to-one by most votes (first on ties) under the direction gate."""
    M, L = feats_r["line_dirs"].shape[:2]
    dev = feats_r["line_dirs"].device
    vote_ok = p2l["mask"] & p2l["seg_n_valid"]
    flat = (torch.arange(M, device=dev)[:, None] * (L * L)
            + p2l["seg_n"].long() * L + p2l["seg_r"].long())
    votes = torch.zeros(M * L * L, dtype=torch.int64, device=dev)
    votes.index_add_(0, flat.reshape(-1), vote_ok.reshape(-1).to(torch.int64))
    votes = votes.reshape(M, L, L)                               # [seg_n, seg_r]
    ang = geometry.line_angle_between(feats_n["line_dirs"][:, :, None, :],
                                      feats_r["line_dirs"][:, None, :, :],
                                      degrees=True)
    gate = ((ang <= angle_deg) & feats_n["line_mask"][:, :, None]
            & feats_r["line_mask"][:, None, :])
    votes = torch.where(gate, votes, 0)
    best_v, best_r = torch.max(votes, dim=2)                     # first max
    col_best = torch.argmax(votes, dim=1)                        # (M, L)
    ok = ((best_v >= min_votes)
          & (torch.gather(col_best, 1, best_r) == torch.arange(L, device=dev)))
    return {"mask": ok, "dir_n": feats_n["line_dirs"],
            "dir_r": _take(feats_r["line_dirs"], best_r), "seg_r": best_r}


def associate_all_pairs(batch, poses, pair_r, pair_n):
    """Associate every pair (pair_r[m], pair_n[m]) at once. batch: stacked
    per-scan feature dict (leading scan axis); poses (N, 6); pair_* (M,)
    int tensors. Returns {"p2l", "p2p", "l2l"} dicts with a leading pair
    axis."""
    pr, pn = pair_r.long(), pair_n.long()
    fr = {k: v[pr] for k, v in batch.items()}
    fn = {k: v[pn] for k, v in batch.items()}
    p2l = associate_point2line_pair(fr, fn, poses[pr], poses[pn])
    p2p = associate_point2plane_pair(fr, fn, poses[pr], poses[pn])
    l2l = associate_line2line_pair(p2l, fr, fn)
    for key in ("seg_n", "seg_n_valid", "seg_r"):
        p2l.pop(key)
    return {"p2l": p2l, "p2p": p2p, "l2l": l2l}
