"""Line tracks across scans and frames, and the track-level camera-LiDAR
association — the port of `panovlm_tpu/models/line_tracks.py`:

  * LidarLineMatch::GenerateTracks: tracks of LiDAR lines across
    neighbouring scans, and the AddLidarLineToLineResidual2 gate;
  * PanoramaLineMatch: image-line tracks across frames. Pairs of frames are
    matched on the device (the great-circle normals rotated through the
    relative pose, gated by normal angle and arc overlap; with descriptors,
    ranked by LBD distance with a ratio test; one-to-one), optionally
    filtered by the port's own pyramidal LK flow (native/lk.cpp, cv2's
    calcOpticalFlowPyrLK at its defaults);
  * CameraLidarTrackAssociate: votes per (image track, LiDAR track) pair,
    and the validated pairs distributed back to every (frame, scan) pair.

Track building is small irregular graph work and stays on the host
(union-find over numpy), with the JAX module's edge and iteration orders:
the union order decides the roots and so the track ids, and the order in
which validated track pairs are visited decides which image line fills a
slot that two of them touch.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..ops import se3
from ..utils.tracks import UnionFind


def _union_tracks(n_nodes, edges, min_length: int):
    """Union-find over node indices; returns (track_id (n_nodes,), counts).
    Nodes not in a long-enough track get -1."""
    uf = UnionFind(n_nodes)
    for a, b in edges:
        uf.union(int(a), int(b))
    roots = np.array([uf.find(i) for i in range(n_nodes)])
    _, inv, counts = np.unique(roots, return_inverse=True, return_counts=True)
    track_id = np.where(counts[inv] >= min_length, inv, -1)
    return track_id.astype(np.int32), counts


def _edges(l2l_assoc, pair_r, pair_n):
    """(p, ln, r_line) for every associated line of every pair."""
    mask = np.asarray(l2l_assoc["mask"])
    seg_r = np.asarray(l2l_assoc["seg_r"])
    p, ln = np.nonzero(mask)
    return p, ln, seg_r[p, ln], np.asarray(pair_r)[p], np.asarray(pair_n)[p]


def lidar_line_tracks(l2l_assoc, pair_r, pair_n, n_scans: int, n_lines: int,
                      min_length: int = 3):
    """Tracks of LiDAR lines from the pairwise line-to-line associations
    (numpy arrays). Node = scan * n_lines + line. Returns track_id
    (n_scans, n_lines) int32, -1 = untracked."""
    _, ln, r_line, pr, pn = _edges(l2l_assoc, pair_r, pair_n)
    edges = zip(pr * n_lines + r_line, pn * n_lines + ln)
    tid, _ = _union_tracks(n_scans * n_lines, edges, min_length)
    return tid.reshape(n_scans, n_lines)


def l2l_track_gate(l2l_assoc, pair_r, pair_n, track_id):
    """Gate for line-to-line residuals: both endpoints in the same track of
    length >= 3. Returns (P, L) bool."""
    mask = np.asarray(l2l_assoc["mask"])
    p, ln, r_line, pr, pn = _edges(l2l_assoc, pair_r, pair_n)
    t1 = track_id[pr, r_line]
    gate = np.zeros(mask.shape, bool)
    gate[p, ln] = (t1 >= 0) & (t1 == track_id[pn, ln])
    return gate


def match_image_lines_pair(arcs_i, arcs_j, pose_i, pose_j, angle_deg: float = 3.0,
                           ratio: float = 0.9):
    """Arc matching between frames i and j (tensors on one device): frame
    j's great-circle normals and mid rays rotated into frame i, gated by
    normal angle (<= angle_deg) and mid-ray angle (<= 1.5 x the mean half
    arc), one-to-one. With "desc" in both dicts the candidates are ranked
    by LBD distance with the ratio test best < ratio x second
    (MatchInitLine, PanoramaLineMatch.cpp:37-46), else by normal angle.
    Returns (Lj,) int64, the index into frame i's arcs or -1."""
    R_ij = se3.exp_so3(pose_i[:3]) @ se3.exp_so3(pose_j[:3]).T
    n_j_in_i = arcs_j["normal"] @ R_ij.T
    mid_j_in_i = arcs_j["mid"] @ R_ij.T
    cosn = torch.abs(torch.einsum("ik,jk->ji", arcs_i["normal"], n_j_in_i))
    ang = torch.arccos(torch.clamp(cosn, -1, 1)) * (180.0 / math.pi)   # (Lj, Li)
    cosm = torch.einsum("ik,jk->ji", arcs_i["mid"], mid_j_in_i)
    mid_ang = torch.arccos(torch.clamp(cosm, -1, 1))
    half_sum = 0.5 * (arcs_i["arc"][None, :] + arcs_j["arc"][:, None])
    ok = ((ang <= angle_deg) & (mid_ang <= half_sum * 1.5)
          & arcs_i["mask"][None, :] & arcs_j["mask"][:, None])
    inf = torch.full_like(ang, math.inf)
    ratio_ok = torch.ones(ang.shape[0], dtype=torch.bool, device=ang.device)
    if "desc" in arcs_i and "desc" in arcs_j:
        from ..ops import lbd
        score = torch.where(ok, lbd.lbd_distance_matrix(arcs_i["desc"], arcs_j["desc"]), inf)
        if score.shape[1] >= 2:
            two = torch.topk(score, 2, dim=1, largest=False).values
            ratio_ok = two[:, 0] < ratio * two[:, 1]
    else:
        score = torch.where(ok, ang, inf)
    best_i = torch.argmin(score, dim=1)
    valid = torch.isfinite(torch.amin(score, dim=1)) & ratio_ok
    # one-to-one: j must win the column of its chosen i
    col_best = torch.argmin(score, dim=0)
    valid = valid & (col_best[best_i] == torch.arange(score.shape[0], device=score.device))
    return torch.where(valid, best_i, torch.full_like(best_i, -1))


def filter_matches_optical_flow(arcs_j, arcs_i, gray_j, gray_i, match, n_samples: int = 10,
                                min_tracked: float = 0.8, max_median_px: float = 60.0,
                                stats=None):
    """FilterLineMatchOpticalFlow (PanoramaLineMatch.cpp:114-159), on the
    host: n_samples points along each matched arc of frame j, tracked into
    frame i by the port's LK (native/lk.py); a match stays when at least
    min_tracked of its points track and the median angle from the tracked
    points to the matched great circle of frame i is at most
    max_median_px * 2 pi / W. arcs_*: numpy arc dicts; gray_*: (H, W)
    float [0, 1] (or uint8) images; match (Lj,) from match_image_lines_pair.
    Returns the filtered copy (numpy). With `stats` (a dict), adds the
    points tracked and those with status 1 under "lk_points" / "lk_ok"."""
    from ..native import lk
    from ..utils.panorama_line import _cam_to_image_np, _image_to_cam_np

    m = np.array(np.asarray(match))
    rows_j = np.nonzero(m >= 0)[0]
    if not len(rows_j):
        return m
    H, W = gray_j.shape[:2]
    e1 = np.asarray(arcs_j["e1"])[rows_j]
    e2 = np.asarray(arcs_j["e2"])[rows_j]
    theta = np.arccos(np.clip((e1 * e2).sum(1), -1.0, 1.0))[:, None]
    t = (np.arange(n_samples, dtype=np.float32) / n_samples)[None, :]
    s = np.sin(np.maximum(theta, 1e-6))
    pts = (np.sin((1 - t) * theta)[..., None] * e1[:, None]
           + np.sin(t * theta)[..., None] * e2[:, None]) / s[..., None]
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True) + 1e-12
    uv_j = _cam_to_image_np(pts, H, W).reshape(-1, 2).astype(np.float32)

    def to_u8(g):
        return (g * 255).astype(np.uint8) if g.dtype != np.uint8 else g
    uv_i, status = lk.track(to_u8(gray_j), to_u8(gray_i), uv_j)
    if stats is not None:
        stats["lk_points"] = stats.get("lk_points", 0) + len(status)
        stats["lk_ok"] = stats.get("lk_ok", 0) + int(status.sum())
    uv_i = uv_i.reshape(len(rows_j), n_samples, 2)
    status = status.reshape(len(rows_j), n_samples)

    normals_i = np.asarray(arcs_i["normal"])[m[rows_j]]     # (Q, 3)
    rays = _image_to_cam_np(uv_i, H, W)                      # (Q, n, 3)
    ang = np.abs(np.arcsin(np.clip(np.einsum("qnk,qk->qn", rays, normals_i), -1.0, 1.0)))
    thresh = max_median_px * 2.0 * np.pi / W
    ang = np.where(status, ang, np.nan)
    with warnings.catch_warnings():          # rows with no point tracked
        warnings.simplefilter("ignore", RuntimeWarning)
        med = np.nanmedian(ang, axis=1)
    ok = (status.mean(1) >= min_tracked) & (med <= thresh)
    m[rows_j[~ok]] = -1
    return m


def image_line_tracks(arc_batch, cam_poses, window: int = 3, min_length: int = 3,
                      grays=None, stats=None):
    """PanoramaLineMatcher::GenerateTracks: tracks of image lines across
    frames i < j <= i + window. arc_batch: stacked arc tensors (N, L, ...)
    on the working device, "desc" included when the matching should use
    it; cam_poses (N, 6). With `grays` (per-frame float [0, 1] images) the
    pair matches are filtered by LK flow first. Returns (N, L) int32 track
    ids (numpy), -1 = untracked. `stats` as in filter_matches_optical_flow."""
    poses = torch.as_tensor(cam_poses)
    n = poses.shape[0]
    L = arc_batch["normal"].shape[1]
    host = ({k: v.cpu().numpy() for k, v in arc_batch.items()} if grays is not None
            else None)
    edges = []
    for i in range(n):
        for j in range(i + 1, min(i + 1 + window, n)):
            ai = {k: v[i] for k, v in arc_batch.items()}
            aj = {k: v[j] for k, v in arc_batch.items()}
            m = match_image_lines_pair(ai, aj, poses[i], poses[j]).cpu().numpy()
            if grays is not None:
                m = filter_matches_optical_flow({k: v[j] for k, v in host.items()},
                                                {k: v[i] for k, v in host.items()},
                                                grays[j], grays[i], m, stats=stats)
            for lj, li in enumerate(m):
                if li >= 0:
                    edges.append((i * L + int(li), j * L + lj))
    tid, _ = _union_tracks(n * L, edges, min_length)
    return tid.reshape(n, L)


def camera_lidar_track_associate(cl_assoc, fi, li, img_track_id, lidar_track_id):
    """AssociateTrack (CameraLidarTrackAssociate.cpp:103-204), on the host:
    each per-pair line association votes for its (image track, LiDAR
    track) pair; a track pair whose votes reach min(track sizes) - 2
    validates, and its member lines are associated in every (frame, scan)
    pair that both tracks touch. Each LiDAR-line slot holds one image line:
    an existing association with a member of the track is kept, an empty
    slot takes the track's first member line on that frame.

    cl_assoc: mask / img_line (P, Ls); fi / li (P,) the frame and scan of
    each pair; img_track_id (n_frames, Li) and lidar_track_id (n_lidars,
    Ls), -1 = untracked (numpy or tensors). Returns (mask, img_line) numpy,
    the updated association arrays."""
    def host(a):
        return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    mask = np.array(host(cl_assoc["mask"]))
    img_line = np.array(host(cl_assoc["img_line"]))
    fi, li = host(fi), host(li)
    P, _ = mask.shape
    img_track_id = host(img_track_id)
    lidar_track_id = host(lidar_track_id)

    votes: dict[tuple, int] = {}
    for p in range(P):
        f, l = int(fi[p]), int(li[p])
        for s in np.nonzero(mask[p])[0]:
            it = int(img_track_id[f, img_line[p, s]])
            lt = int(lidar_track_id[l, s])
            if it >= 0 and lt >= 0:
                votes[(it, lt)] = votes.get((it, lt), 0) + 1

    # track sizes = number of member (view, line) features
    img_sizes = np.bincount(img_track_id[img_track_id >= 0].ravel(),
                            minlength=max(img_track_id.max() + 1, 1))
    lidar_sizes = np.bincount(lidar_track_id[lidar_track_id >= 0].ravel(),
                              minlength=max(lidar_track_id.max() + 1, 1))
    # a set, visited in its own order, as the JAX module visits it: that
    # order decides the image line of a slot two validated pairs touch
    good = {(it, lt) for (it, lt), v in votes.items()
            if v >= min(img_sizes[it], lidar_sizes[lt]) - 2}
    if not good:
        return mask, img_line

    new_mask = np.zeros_like(mask)
    new_line = np.array(img_line)
    for it, lt in good:
        for p in range(P):
            f, l = int(fi[p]), int(li[p])
            img_members = np.nonzero(img_track_id[f] == it)[0]
            if not len(img_members):
                continue
            for s in np.nonzero(lidar_track_id[l] == lt)[0]:
                new_mask[p, s] = True
                if not (mask[p, s] and img_track_id[f, img_line[p, s]] == it):
                    new_line[p, s] = img_members[0]
    return new_mask, new_line
