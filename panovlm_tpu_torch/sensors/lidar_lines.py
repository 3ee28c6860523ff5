"""3D line segments from LiDAR edge points — ported from
`panovlm_tpu/sensors/lidar_lines.py` (greedy RANSAC over an up-front pool of
two-point hypotheses, then one batched refinement of every claimed line).

Batched over scans: pts (B,P,3). The greedy claim loop runs for all scans at
once and stops when every scan is done (each exit test is one host sync).
The uint32 hypothesis hashes are emulated in int64 masked to 32 bits, and the
inlier test evaluates its multiply-adds as the JAX package's compiled program
does (`ops/exact.py`), so hypothesis draws and inlier sets come out bit-equal.
"""

from __future__ import annotations

import torch

from ..ops import exact, geometry
from ..ops.exact import fma

MAX_LINES = 64
N_HYPOTHESES = 256
INLIER_DIST = 0.05
GAP = 0.5
MIN_POINTS = 5
MIN_LENGTH = 0.3
MIN_ROWS = 3

_U32 = 0xFFFFFFFF


def _hyp_priorities(P: int, n_draw: int, l: int, seed: int, device="cpu"):
    """(P, n_draw) uint32 hash priorities (values in int64): column-wise
    argmax over a masked pool draws one uniform sample per column."""
    i = torch.arange(P, dtype=torch.int64, device=device)[:, None]
    h = torch.arange(n_draw, dtype=torch.int64, device=device)[None, :]
    a = ((i + 1) * 2654435761) & _U32
    b = ((h + 1) * 40499 + ((l * 69069) & _U32) + ((seed * 2654435761) & _U32)) & _U32
    x = ((a ^ b) * 2246822519) & _U32
    return x ^ (x >> 15)


def extract_lines(pts, mask, rows, max_lines: int = MAX_LINES,
                  n_hyp: int = N_HYPOTHESES, seed: int = 0):
    """Up to max_lines 3D segments per scan from masked edge points.

    pts (B,P,3), mask (B,P), rows (B,P) scan ring (-1 invalid). Returns dict
    points (B,L,3), dirs (B,L,3), endpoints (B,L,2,3), mask (B,L),
    point_label (B,P) int32 owning line or -1."""
    B, P, _ = pts.shape
    L = max_lines
    NH = 8 * n_hyp
    dev = pts.device
    bidx = torch.arange(B, device=dev)[:, None]

    # hypothesis pool: NH point pairs drawn from the valid set, kept when the
    # two points lie 2 cm .. 2 m apart
    pri = _hyp_priorities(P, 2 * NH, 0, seed, dev)
    pri = torch.where(mask[:, :, None], pri[None], torch.zeros((), dtype=pri.dtype,
                                                               device=dev))
    iab = torch.argmax(pri, dim=1)                                  # (B, 2NH)
    del pri
    ia, ib = iab[:, :NH], iab[:, NH:]
    pa, pb = pts[bidx, ia], pts[bidx, ib]                           # (B, NH, 3)
    diff = pb - pa
    sep = exact.norm3(diff)
    ok_h = mask[bidx, ia] & mask[bidx, ib] & (sep > 0.02) & (sep < 2.0)
    d = diff / (sep[..., None] + 1e-12)

    # (NH, P) inliers in difference form: dist^2 = |w|^2 - (w.d)^2, w = p - pa
    wx = pts[:, None, :, 0] - pa[:, :, 0, None]
    wy = pts[:, None, :, 1] - pa[:, :, 1, None]
    wz = pts[:, None, :, 2] - pa[:, :, 2, None]
    wd = exact.sum_of_products([(wx, d[:, :, 0, None]), (wy, d[:, :, 1, None]),
                                (wz, d[:, :, 2, None])])
    dist2 = fma(-wd, wd, exact.sum_of_products([(wx, wx), (wy, wy), (wz, wz)]))
    del wx, wy, wz, wd
    inl = (dist2 < INLIER_DIST * INLIER_DIST) & mask[:, None, :] & ok_h[:, :, None]
    del dist2

    # greedy claiming: each round takes the hypothesis with the most
    # unclaimed inliers (first on ties) and claims them
    remaining = mask.clone()
    chosen = torch.full((B, L), -1, dtype=torch.int64, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    for l in range(L):
        votes = torch.sum(inl & remaining[:, None, :], dim=-1)       # (B, NH)
        bv, best = torch.max(votes, dim=-1)
        go = (bv >= MIN_POINTS) & ~done
        mem = inl[torch.arange(B, device=dev), best] & remaining
        remaining = torch.where(go[:, None], remaining & ~mem, remaining)
        chosen[:, l] = torch.where(go, best, -1)
        done = done | ~go
        if bool(done.all()):
            break

    # batched refinement: a point belongs to the first chosen hypothesis
    # that covers it (claim order), lines may grow into unowned points
    line_ok = chosen >= 0                                           # (B, L)
    inl_rows = inl[bidx, torch.clamp_min(chosen, 0)] & line_ok[..., None]
    del inl
    lids = torch.arange(L, device=dev)[:, None]
    has_owner = torch.any(inl_rows, dim=1)
    owner = torch.where(has_owner, torch.argmax(inl_rows.to(torch.uint8), dim=1), L)
    member0 = inl_rows & (owner[:, None, :] == lids)
    eligible = mask[:, None, :] & ((owner[:, None, :] == lids)
                                   | (owner == L)[:, None, :])

    pts_l = pts[:, None].expand(B, L, P, 3)
    fit = geometry.fit_line_pca(pts_l, member0)
    dist = geometry.point_to_line_distance(pts_l, fit["point"][:, :, None],
                                           fit["dir"][:, :, None])
    m1 = (dist < INLIER_DIST) & eligible
    fit = geometry.fit_line_pca(pts_l, m1)
    c, u = fit["point"], fit["dir"]

    # longest contiguous run along each line (gap <= GAP) on a GAP-sized
    # histogram of the along-line coordinate
    NB = 128
    t = torch.sum((pts[:, None] - c[:, :, None]) * u[:, :, None], dim=-1)  # (B,L,P)
    inf = torch.full_like(t, float("inf"))
    t0 = torch.amin(torch.where(m1, t, inf), dim=-1)
    tbin = torch.clamp(((t - t0[..., None]) / GAP).to(torch.int64), 0, NB - 1)
    hist = torch.zeros((B, L, NB), dtype=torch.int64, device=dev)
    hist.scatter_add_(-1, tbin, m1.to(torch.int64))
    occ = hist > 0
    starts = occ & ~torch.nn.functional.pad(occ[..., :-1], (1, 0))
    run_id = torch.cumsum(starts.to(torch.int64), dim=-1) - 1
    run_cnt = torch.zeros((B, L, NB), dtype=torch.int64, device=dev)
    run_cnt.scatter_add_(-1, torch.clamp_min(run_id, 0), torch.where(occ, hist, 0))
    best_run = torch.argmax(run_cnt, dim=-1)
    bin_in_best = (run_id == best_run[..., None]) & occ
    member = m1 & torch.gather(bin_in_best, -1, tbin)

    n_mem = torch.sum(member, dim=-1)
    t_lo = torch.amin(torch.where(member, t, inf), dim=-1)
    t_hi = torch.amax(torch.where(member, t, -inf), dim=-1)
    length = torch.where(n_mem > 0, t_hi - t_lo, torch.zeros_like(t_lo))
    row_oh = (torch.clamp(rows, 0, 16)[:, None, :]
              == torch.arange(16, device=dev)[None, :, None])       # (B,16,P)
    rows_present = torch.any(row_oh[:, None] & member[:, :, None], dim=-1)
    n_rows = torch.sum(rows_present, dim=-1)
    accept = (line_ok & (n_mem >= MIN_POINTS) & (length >= MIN_LENGTH)
              & (n_rows >= MIN_ROWS) & (n_rows * 2 >= n_mem))

    fit2 = geometry.fit_line_pca(pts_l, member)
    c2, u2 = fit2["point"], fit2["dir"]
    e0 = c2 + t_lo[..., None] * u2
    e1 = c2 + t_hi[..., None] * u2
    a3 = accept[..., None]
    ends = torch.where(a3[..., None], torch.stack([e0, e1], dim=-2), 0.0)

    # point labels: the first accepted line whose members cover the point
    lab_mat = member & accept[..., None]
    has_lab = torch.any(lab_mat, dim=1)
    labels = torch.where(has_lab, torch.argmax(lab_mat.to(torch.uint8), dim=1), -1)
    return {"points": torch.where(a3, c2, 0.0),
            "dirs": torch.where(a3, u2, 0.0),
            "endpoints": ends,
            "mask": accept,
            "point_label": labels.to(torch.int32)}
