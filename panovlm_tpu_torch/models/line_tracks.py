"""LiDAR line tracks across scans and the line-to-line track gate — the
odometry part of `panovlm_tpu/models/line_tracks.py`
(LidarLineMatch::GenerateTracks + the AddLidarLineToLineResidual2 gate).
Track building is small irregular graph work and stays on the host
(union-find over numpy)."""

from __future__ import annotations

import numpy as np

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
