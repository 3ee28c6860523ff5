"""Velodyne VLP-16 frontend — range image, segmentation, curvature, greedy
feature picking — ported from `panovlm_tpu/sensors/velodyne.py`: the
ADAPTIVE (method 3) and DOUBLE_EXTRACTION (method 2) edge sets, with plain
elevation binning or ReOrderVLP2's ring repair (`repair_ring_conflicts`).

Every function takes a leading scan axis B where the JAX module was vmapped.
Threshold decisions match the JAX package bit for bit where their inputs
do: float expressions that feed a decision are evaluated as the JAX
package's compiled program evaluates them (`ops/exact.py`: fused
multiply-adds, correctly rounded sqrt), the row prefix sum reproduces the
blocked order of XLA's CPU cumsum (`_cumsum_blocked`), and the decimation
hash is emulated in int64 masked to 32 bits. The ring repair and the
hysteresis decide in integers only. Transcendental functions (atan2,
arccos) may still differ from XLA's in the last bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import exact
from ..ops.exact import div_const, f32, fma, mod, rdiv

N_SCANS = 16
HORIZON = 1800
MIN_RANGE = 0.5
MIN_VALID_POINTS = 4000

AXIS_SWAP = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]], np.float32)

CAP_SHARP = 288       # 3 picks x 6 sectors x 16 scans
CAP_EDGE = 1024
CAP_FLAT = 512        # 4 picks x 6 sectors x 16 scans = 384
CAP_SURF = 4096
CAP_LINES = 64

_TWO_PI = 2 * math.pi
_RAD2DEG = 180.0 / math.pi


def preprocess_cloud(xyz: np.ndarray) -> tuple[np.ndarray, bool]:
    """Axis swap lidar->camera + min-range filter (Velodyne.cpp:124-140).
    Host-side data prep. Returns (points, valid_scan)."""
    pts = np.asarray(xyz[:, :3], np.float32)
    pts = pts[np.isfinite(pts).all(axis=1)]
    pts = pts @ AXIS_SWAP.T
    keep = (pts ** 2).sum(axis=1) >= MIN_RANGE * MIN_RANGE
    pts = pts[keep]
    return pts, len(pts) >= MIN_VALID_POINTS


def pad_points(pts: np.ndarray, cap: int) -> tuple[np.ndarray, np.ndarray]:
    n = min(len(pts), cap)
    out = np.zeros((cap, 3), np.float32)
    out[:n] = pts[:n]
    mask = np.zeros((cap,), bool)
    mask[:n] = True
    return out, mask


# ----------------------------------------------------------------------------
# shifts and the prefix sum
# ----------------------------------------------------------------------------

def _cumsum_blocked(x, base: int = 16):
    """Inclusive float32 prefix sum along the last axis in the order XLA's
    CPU backend uses for `jnp.cumsum`: sequential inside blocks of `base`,
    the block totals prefix-summed the same way (recursively), then added
    back. Same values as the JAX package, so curvature ties break alike."""
    n = x.shape[-1]
    if n <= base:
        out = torch.empty_like(x)
        acc = torch.zeros_like(x[..., 0])
        for i in range(n):
            acc = acc + x[..., i]
            out[..., i] = acc
        return out
    nb = -(-n // base)
    xp = torch.nn.functional.pad(x, (0, nb * base - n))
    inner = _cumsum_blocked(xp.reshape(*x.shape[:-1], nb, base), base)
    tot = _cumsum_blocked(inner[..., -1], base)
    excl = torch.nn.functional.pad(tot[..., :-1], (1, 0))
    return (inner + excl[..., None]).reshape(*x.shape[:-1], nb * base)[..., :n]


def _shift_clamp(x, k: int, dim: int):
    """out[i] = x[clamp(i + k)] along `dim`, edges clamped."""
    if k == 0:
        return x
    W = x.shape[dim]
    idx = torch.clamp(torch.arange(W, device=x.device) + k, 0, W - 1)
    return torch.index_select(x, dim, idx)


def _shift_fill(x, k: int, dim: int, fill):
    """out[i] = x[i - k] along `dim`; vacated slots get `fill`."""
    W = x.shape[dim]
    a = abs(k)
    if a == 0:
        return x
    if a >= W:
        return torch.full_like(x, fill)
    pad = torch.full_like(x.narrow(dim, 0, a), fill)
    if k > 0:
        return torch.cat([pad, x.narrow(dim, 0, W - a)], dim=dim)
    return torch.cat([x.narrow(dim, a, W - a), pad], dim=dim)


# ----------------------------------------------------------------------------
# packet-order conflict repair (ReOrderVLP2)
# ----------------------------------------------------------------------------

# VLP-16 interleaved firing order (Velodyne.cpp:246-254): within one firing
# column the rings arrive as 0,8,1,9,...,7,15. _S2O[ring] = position in the
# firing sequence; _O2S is the canonical ring sequence.
_S2O = np.empty(16, np.int64)
_S2O[:8] = 2 * np.arange(8)
_S2O[8:] = 2 * np.arange(8, 16) - 15
_O2S = np.empty(16, np.int64)
_O2S[_S2O] = np.arange(16)


def _first_true(m):
    """Index of the first True along the last axis, 0 where there is none
    (jnp.argmax of a bool array)."""
    n = m.shape[-1]
    idx = torch.where(m, torch.arange(n, device=m.device), n)
    first = torch.min(idx, dim=-1).values
    return torch.where(first < n, first, torch.zeros_like(first))


def _lcs_len(seq, seq_valid, ref):
    """Length of the longest common subsequence of each masked sequence
    seq (...,L) (the entries where seq_valid) and the fixed sequence ref
    (R,) (LongestCommonSubsequence, Velodyne.cpp:188-211): the L x R
    dynamic programme, vectorised over the leading axes. -> (...) int64."""
    R = ref.shape[0]
    dp = [torch.zeros(seq.shape[:-1], dtype=torch.int64, device=seq.device)] * (R + 1)
    for i in range(seq.shape[-1]):
        s, v = seq[..., i], seq_valid[..., i]
        new = [dp[0]]
        for k in range(1, R + 1):
            new.append(torch.where(s == int(ref[k - 1]), dp[k - 1] + 1,
                                   torch.maximum(dp[k], new[k - 1])))
        dp = [torch.where(v, n_k, d_k) for n_k, d_k in zip(new, dp)]
    return dp[R]


def repair_ring_conflicts(pts, mask, n_scans: int = N_SCANS, max_cols: int = 4096):
    """ReOrderVLP2 (Velodyne.cpp:213-369): where two points of one firing
    column land on the same elevation ring (noise at a ring boundary), try
    ring - 1 for the first of them and ring + 1 for the second, and keep the
    assignment whose ring sequence has the longer LCS against the canonical
    interleave; only each column's most occupied conflict is repaired, as in
    the JAX package. Firing columns are the runs of rising firing order;
    points past the first max_cols columns keep their elevation rings (the
    JAX package's wrapped index -1 writes nothing there either: its scatter
    lands on column max_cols - 1, which has a smaller first count, or on a
    slot >= 16).

    pts (B,P,3), mask (B,P) -> (B,P) int64 ring per point, -1 invalid."""
    B, P, _ = pts.shape
    dev = pts.device
    ring = elevation_ring(pts)
    ok = mask & (ring >= 0) & (ring < n_scans)
    ring_c = torch.clamp(ring, 0, n_scans - 1)
    order = torch.as_tensor(_S2O, device=dev)[ring_c]

    # the previous valid point's firing order; a new column starts where it
    # falls
    idx = torch.arange(P, device=dev).expand(B, P)
    last = torch.cummax(torch.where(ok, idx, -1), dim=1).values
    prev_i = torch.nn.functional.pad(last[:, :-1], (1, 0), value=-1)
    prev_order = torch.where(prev_i >= 0,
                             torch.gather(order, 1, torch.clamp_min(prev_i, 0)), -1)
    boundary = ok & (order < prev_order)
    col = torch.cumsum(boundary.to(torch.int64), dim=1)
    col = torch.where(ok & (col < max_cols), col, -1)

    # slot within the column: the valid-prefix count minus the column's first
    c = torch.cumsum(ok.to(torch.int64), dim=1)
    big = 2 ** 30
    col_first = torch.full((B, max_cols + 1), big, dtype=torch.int64, device=dev)
    col_first.scatter_reduce_(1, torch.where(col >= 0, col, max_cols),
                              torch.where(ok, c, big), reduce="amin")
    slot = torch.where(ok, c - torch.gather(col_first, 1, torch.clamp_min(col, 0)), 16)
    in_col = ok & (slot < 16) & (col >= 0)

    # (max_cols, 16) matrices of ring and point index; one spare cell takes
    # the points outside every column
    cell = torch.where(in_col, col * 16 + slot, max_cols * 16)
    ring_m = torch.full((B, max_cols * 16 + 1), -1, dtype=torch.int64, device=dev)
    ring_m.scatter_(1, cell, torch.where(in_col, ring_c, -1))
    pidx_m = torch.full_like(ring_m, -1)
    pidx_m.scatter_(1, cell, torch.where(in_col, idx, -1))
    ring_m = ring_m[:, :-1].reshape(B, max_cols, 16)
    pidx_m = pidx_m[:, :-1].reshape(B, max_cols, 16)
    valid_m = ring_m >= 0

    # the most occupied ring of each column (the first on ties)
    occ = torch.sum(ring_m[..., None] == torch.arange(n_scans, device=dev), dim=2)
    top = torch.max(occ, dim=-1, keepdim=True).values
    conflict_ring = _first_true(occ == top)
    has_conflict = top[..., 0] >= 2

    # the first and second slots on the conflicted ring
    is_conf = valid_m & (ring_m == conflict_ring[..., None])
    slots = torch.arange(16, device=dev)
    first_s = _first_true(is_conf)
    second_s = _first_true(is_conf & (slots > first_s[..., None]))

    # both candidate repairs scored in one batch
    cand_slot = torch.stack([first_s, second_s])
    cand_ring = torch.stack([conflict_ring - 1, conflict_ring + 1])
    seqs = torch.where(slots == cand_slot[..., None], cand_ring[..., None], ring_m)
    s1, s2 = _lcs_len(seqs, valid_m.expand_as(seqs), _O2S)
    s1 = torch.where(conflict_ring - 1 >= 0, s1, 0)
    s2 = torch.where(conflict_ring + 1 < n_scans, s2, 0)

    use_first = s1 > s2
    fix_slot = torch.where(use_first, first_s, second_s)
    fix_ring = torch.where(use_first, conflict_ring - 1, conflict_ring + 1)
    fix_pt = torch.gather(pidx_m, 2, fix_slot[..., None])[..., 0]
    do_fix = has_conflict & (fix_ring >= 0) & (fix_ring < n_scans) & (fix_pt >= 0)

    out = torch.nn.functional.pad(torch.where(ok, ring_c, -1), (0, 1))
    out.scatter_(1, torch.where(do_fix, fix_pt, P), torch.where(do_fix, fix_ring, -1))
    return out[:, :P]


# ----------------------------------------------------------------------------
# range image
# ----------------------------------------------------------------------------

def _azimuth(x, z):
    ori = torch.atan2(x, z)
    return torch.where(ori < 0, ori + _TWO_PI, ori)


def scan_start_ori(pts, mask):
    """Azimuth of the first valid point of each scan (the reference's
    start_ori, Velodyne.cpp:398-400). pts (B,P,3), mask (B,P) -> (B,)."""
    ori = _azimuth(pts[..., 0], pts[..., 2])
    first = torch.argmax(mask.to(torch.uint8), dim=-1)
    return torch.gather(ori, -1, first[..., None])[..., 0]


def sweep_fraction_from(pts, start_ori):
    """Sweep fraction in [0,1) of every point, from a per-scan start
    azimuth. pts (B,P,3), start_ori (B,) -> (B,P)."""
    ori = _azimuth(pts[..., 0], pts[..., 2])
    return div_const(mod(ori - start_ori[..., None], _TWO_PI), _TWO_PI)


def elevation_ring(pts):
    """VLP-16 ring of each point from its elevation (VerticalAngleToScanID,
    Velodyne.cpp:170-186), out-of-range rings included. pts (...,3) ->
    (...) int64."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    vert = torch.atan2(-y, exact.sqrt(fma(x, x, z * z)))
    return torch.floor(fma(vert, torch.full_like(vert, _RAD2DEG),
                           torch.full_like(vert, 15.0)) / 2.0 + 0.5).to(torch.int64)


def build_range_image(pts, mask, n_scans: int = N_SCANS, horizon: int = HORIZON,
                      ring=None):
    """Scatter points into the (n_scans, horizon) range image of each scan:
    ring from the VLP-16 elevation formula (or `ring` (B,P), -1 invalid, as
    `repair_ring_conflicts` gives it), column from the azimuth relative
    to the first valid point. A cell keeps its nearest return (range
    quantized to 2 mm), ties to the lowest point index — the JAX sort's
    order, here as one scatter-min of packed (range, index) keys.
    pts (B,P,3), mask (B,P) -> dict of (B,S,H) xyz/range/valid."""
    B, P, _ = pts.shape
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    rng = exact.sqrt(exact.sum_of_products([(x, x), (y, y), (z, z)]))
    if ring is None:
        ring = elevation_ring(pts)
    ring_ok = (ring >= 0) & (ring < n_scans)
    ring = torch.clamp(ring, 0, n_scans - 1)

    rel = mod(_azimuth(x, z) - scan_start_ori(pts, mask)[..., None], _TWO_PI)
    col = torch.remainder(torch.round(div_const(rel, _TWO_PI / horizon)).to(torch.int64),
                          horizon)

    ok = mask & ring_ok & (rng > 0)
    rq = torch.clamp(torch.round(div_const(rng, 0.002)), 0, 32766).to(torch.int64)
    SH = n_scans * horizon
    cell = torch.where(ok, ring * horizon + col, torch.full_like(col, SH))
    key = rq * P + torch.arange(P, device=pts.device)
    big = 32767 * P
    best = torch.full((B, SH + 1), big, dtype=torch.int64, device=pts.device)
    best.scatter_reduce_(1, cell, key, reduce="amin")
    best = best[:, :SH]
    has = best < big
    win = torch.where(has, best % P, torch.zeros_like(best))
    xyz = torch.gather(pts, 1, win[..., None].expand(B, SH, 3))
    xyz = torch.where(has[..., None], xyz, torch.zeros_like(xyz))
    xyz = xyz.reshape(B, n_scans, horizon, 3)
    sq = exact.sumsq3(xyz)
    valid = sq > 0
    xyz = torch.where(valid[..., None], xyz, torch.zeros_like(xyz))
    r_img = torch.where(valid, exact.sqrt(sq), torch.zeros_like(sq))
    return {"range": r_img, "xyz": xyz, "valid": valid}


def compact_rows(img):
    """Per-row compaction: valid cells in column order, padded right (the
    reference's reordered scan-line sequence, Velodyne.cpp:506-520)."""
    valid = img["valid"]
    H = valid.shape[-1]
    order = torch.sort((~valid).to(torch.int8), dim=-1, stable=True).indices
    count = torch.sum(valid, dim=-1)
    out_valid = torch.arange(H, device=valid.device) < count[..., None]
    xyz = torch.gather(img["xyz"], -2, order[..., None].expand(*order.shape, 3))
    xyz = torch.where(out_valid[..., None], xyz, torch.zeros_like(xyz))
    ground = torch.gather(img["ground"], -1, order) & out_valid
    return {
        "xyz": xyz,
        "range": torch.where(out_valid, exact.norm3(xyz), torch.zeros_like(xyz[..., 0])),
        "col": torch.where(out_valid, order, torch.zeros_like(order)),
        "valid": out_valid,
        "ground": ground,
        "count": count,
    }


# ----------------------------------------------------------------------------
# segmentation (LeGO-LOAM angle criterion, label propagation)
# ----------------------------------------------------------------------------

def _seg_run_min(lab, conn, dim: int, big: int):
    """Broadcast each run's minimum label to its members; conn[i] means
    element i joins i-1 along `dim`. Bidirectional segmented doubling."""
    N = lab.shape[dim]
    cf = conn
    cb = _shift_fill(conn, -1, dim, False)
    d = 1
    while d < N:
        lab = torch.where(cf, torch.minimum(lab, _shift_fill(lab, d, dim, big)), lab)
        lab = torch.where(cb, torch.minimum(lab, _shift_fill(lab, -d, dim, big)), lab)
        cf = cf & _shift_fill(cf, d, dim, False)
        cb = cb & _shift_fill(cb, -d, dim, False)
        d *= 2
    return lab


def segment_range_image(r_img, valid, iters: int = 4, theta_deg: float = 20.0):
    """Connected components on the range image (Segmentation,
    Velodyne.cpp:1438-1595): neighbours join when
    atan2(d2 sin(a), d1 - d2 cos(a)) > theta; a component keeps its points
    when it has >= 30 cells, or >= 5 cells spanning >= 3 rows. The label
    propagation runs the JAX package's fixed `iters` rounds.
    r_img, valid (B,S,H) -> keep (B,S,H)."""
    B, S, H = r_img.shape
    alpha_x = f32(np.radians(0.2))
    alpha_y = f32(np.radians(2.0))
    theta = f32(np.radians(theta_deg))

    def connected(ra, rb, alpha):
        d1 = torch.maximum(ra, rb)
        d2 = torch.minimum(ra, rb)
        ang = torch.atan2(d2 * f32(math.sin(alpha)),
                          fma(-d2, torch.full_like(d2, f32(math.cos(alpha))), d1))
        return ang > theta

    left = torch.roll(r_img, 1, dims=-1)
    left_ok = torch.roll(valid, 1, dims=-1)
    conn_left = connected(r_img, left, alpha_x) & valid & left_ok
    up = _shift_fill(r_img, 1, 1, 0.0)
    up_ok = _shift_fill(valid, 1, 1, False)
    conn_up = connected(r_img, up, alpha_y) & valid & up_ok

    big = S * H
    lin = torch.arange(S * H, device=r_img.device, dtype=torch.int32).reshape(S, H)
    labels = torch.where(valid, lin, big)
    conn_row = conn_left.clone()
    conn_row[..., 0] = False
    wrap = conn_left[..., 0]
    for _ in range(iters):
        labels = _seg_run_min(labels, conn_row, 2, big)
        bigs = torch.full_like(labels[..., 0], big)
        labels[..., 0] = torch.minimum(labels[..., 0],
                                       torch.where(wrap, labels[..., -1], bigs))
        labels[..., -1] = torch.minimum(labels[..., -1],
                                        torch.where(wrap, labels[..., 0], bigs))
        labels = _seg_run_min(labels, conn_up, 1, big)
        labels = torch.where(valid, labels, big)

    # component size and number of distinct rows per label
    flat = labels.reshape(B, S * H).to(torch.int64)
    vflat = valid.reshape(B, S * H)
    size = torch.zeros((B, big + 1), dtype=torch.int64, device=r_img.device)
    size.scatter_add_(1, flat, vflat.to(torch.int64))
    rows = torch.arange(S, device=r_img.device).repeat_interleave(H)
    occ = torch.zeros((B, (big + 1) * S), dtype=torch.bool, device=r_img.device)
    occ.scatter_(1, flat * S + rows, vflat)
    n_rows = occ.reshape(B, big + 1, S).sum(-1)
    size_of = torch.gather(size, 1, flat)
    rows_of = torch.gather(n_rows, 1, flat)
    keep = vflat & ((size_of >= 30) | ((size_of >= 5) & (rows_of >= 3)))
    return keep.reshape(B, S, H)


def mark_ground(xyz, valid, max_ground_ring: int = 8, slope_deg: float = 10.0):
    """Ground cells: on the downward rings, the step between vertically
    adjacent cells of one column is within slope_deg of horizontal (camera
    convention, y down). xyz (B,S,H,3), valid (B,S,H) -> (B,S,H) bool."""
    G = max_ground_ring
    d = xyz[:, 1:G + 1] - xyz[:, :G]
    horiz = exact.sqrt(fma(d[..., 0], d[..., 0], d[..., 2] * d[..., 2]))
    slope = torch.atan2(torch.abs(d[..., 1]), horiz) * _RAD2DEG
    flat_step = (slope < slope_deg) & valid[:, 1:G + 1] & valid[:, :G]
    ground = torch.zeros_like(valid)
    ground[:, :G] |= flat_step
    ground[:, 1:G + 1] |= flat_step
    return ground & valid


# ----------------------------------------------------------------------------
# curvature, view angle, picking
# ----------------------------------------------------------------------------

def adaptive_curvature(seq, max_window: int = 16):
    """ADAPTIVE curvature (Velodyne.cpp:625-663): window radius m from the
    local point spacing (k = ceil(0.08 / spacing) per side, symmetric max),
    curvature = |sum(range[i-m..i+m]) - (2m+1) range[i]| / (2m).
    Returns (curvature (B,S,W), m, window_ok)."""
    xyz, rng, valid, count = seq["xyz"], seq["range"], seq["valid"], seq["count"]
    W = rng.shape[-1]
    idx = torch.arange(W, device=rng.device)

    def side_k(direction):
        p4 = _shift_clamp(xyz, direction * 4, -2)
        spacing = torch.clamp_min(exact.norm3(p4 - xyz) / 4.0, f32(1e-4))
        return torch.clamp(torch.ceil(rdiv(0.08, spacing)), 1, max_window).to(torch.int64)

    m = torch.maximum(side_k(-1), side_k(+1))
    csum = _cumsum_blocked(torch.where(valid, rng, torch.zeros_like(rng)))
    csum = torch.nn.functional.pad(csum, (1, 0))                   # (.., W+1)
    hi = torch.clamp(idx + m + 1, max=W)
    lo = torch.clamp(idx - m, min=0)
    win_sum = torch.gather(csum, -1, hi) - torch.gather(csum, -1, lo)
    n_win = (2 * m + 1).to(rng.dtype)
    curv = torch.abs(fma(-n_win, rng, win_sum)) / torch.clamp_min(2 * m, 1).to(rng.dtype)
    window_ok = (idx - m >= 0) & (idx + m < count[..., None]) & valid
    curv = torch.where(window_ok, curv, torch.full_like(curv, -1.0))
    return curv, m, window_ok


def view_angles(seq):
    """Angle between the beam and the local surface chord over a fixed +-5
    window, in degrees (livox-loam eq. 4; Velodyne.cpp:803-812)."""
    xyz, rng = seq["xyz"], seq["range"]
    b = _shift_clamp(xyz, -5, -2) - _shift_clamp(xyz, 5, -2)
    dot = torch.abs(exact.dot3(xyz, b))
    cosv = dot / torch.clamp_min(rng * exact.norm3(b), f32(1e-9))
    return torch.arccos(torch.clamp(cosv, -1.0, 1.0)) * _RAD2DEG


def _sector_ids(seq):
    """Six curvature sectors per scan line over the interior [5, count-6]
    (Velodyne.cpp:700-712). Returns (sec in 0..5 or -1, interior)."""
    count = seq["count"][..., None]
    W = seq["range"].shape[-1]
    idx = torch.arange(W, device=count.device)
    length = count - 11
    interior = (idx >= 5) & (idx <= count - 6) & seq["valid"] & (length >= 6)
    sec = torch.clamp(torch.div((idx - 5) * 6, torch.clamp_min(length, 1),
                                rounding_mode="floor"), 0, 5)
    return torch.where(interior, sec, torch.full_like(sec, -1)), interior


def _suppression_extents(xyz, max_off: int = 16):
    """Per-point suppression extents (Velodyne.cpp:969-988): a pick at
    column i disables i+1..i+Rext[i] and i-1..i-Lext[i]. Offsets 1..5 stop
    at a > 22.36 cm gap between consecutive points, farther offsets when the
    point is > 6 cm from the pick. Returns (Lext, Rext) int64 in [0, max_off]."""
    W = xyz.shape[-2]
    idx = torch.arange(W, device=xyz.device)
    exts = []
    for direction in (-1, 1):
        stopped = torch.zeros(xyz.shape[:-1], dtype=torch.bool, device=xyz.device)
        ext = torch.zeros(xyz.shape[:-1], dtype=torch.int64, device=xyz.device)
        for l in range(1, max_off + 1):
            j = idx + direction * l
            oob = (j < 0) | (j >= W)
            pj = _shift_clamp(xyz, direction * l, -2)
            if l <= 5:
                brk = exact.sumsq3(pj - _shift_clamp(xyz, direction * (l - 1), -2)) > f32(0.05)
            else:
                brk = exact.sumsq3(pj - xyz) > f32(0.0036)
            stopped = stopped | brk | oob
            ext = torch.where(stopped, ext, torch.full_like(ext, l))
        exts.append(ext)
    return exts[0], exts[1]


def greedy_pick(seq, curv, eligible, n_picks: int, pick_largest: bool,
                extents):
    """Greedy per-(scan line, sector) picking with neighbour suppression
    (Velodyne.cpp:905-989 edges, :1117-1160 planes): each round takes the
    extreme-curvature eligible point of every sector at once (first index on
    ties) and disables its suppression interval.

    Returns (picked, disabled (B,S,W) bool, pick_idx (B,n_picks,6,S) int64,
    pick_ok (B,n_picks,6,S) bool), rounds in order."""
    sec, _ = _sector_ids(seq)
    sign = 1.0 if pick_largest else -1.0
    Lext, Rext = extents
    W = curv.shape[-1]
    colidx = torch.arange(W, device=curv.device)
    sec_onehot = sec[:, None] == torch.arange(6, device=curv.device)[None, :, None, None]
    picked = torch.zeros_like(eligible)
    disabled = torch.zeros_like(eligible)
    neg_inf = torch.full_like(curv, -math.inf)
    pidx, pok = [], []
    for _ in range(n_picks):
        key = torch.where(eligible & ~picked & ~disabled, sign * curv, neg_inf)
        key6 = torch.where(sec_onehot, key[:, None], neg_inf[:, None])   # (B,6,S,W)
        kmax, idx6 = torch.max(key6, dim=-1)                              # first max
        ok6 = kmax > -math.inf
        pick6 = (colidx == idx6[..., None]) & ok6[..., None]
        picked = picked | torch.any(pick6, dim=1)
        L6 = torch.where(ok6, torch.gather(Lext[:, None].expand_as(key6), -1,
                                           idx6[..., None])[..., 0], 0)
        R6 = torch.where(ok6, torch.gather(Rext[:, None].expand_as(key6), -1,
                                           idx6[..., None])[..., 0], 0)
        lo = (idx6 - L6)[..., None]
        hi = (idx6 + R6)[..., None]
        dis6 = (colidx >= lo) & (colidx <= hi) & ok6[..., None]
        disabled = disabled | torch.any(dis6, dim=1)
        pidx.append(idx6)
        pok.append(ok6)
    return picked, disabled, torch.stack(pidx, dim=1), torch.stack(pok, dim=1)


def picks_to_buffer(seq, pidx, pok, cap: int, extra=()):
    """Gather picked points into (B, cap, ...) buffers, round-major (pick
    round 0 of every sector and line first). Returns (pts, mask, rows,
    *extra channels)."""
    B, n, six, S = pidx.shape
    rows = torch.arange(S, device=pidx.device).expand(B, n, six, S)
    flat_idx = pidx.reshape(B, -1)[:, :cap]
    flat_rows = rows.reshape(B, -1)[:, :cap]
    flat_ok = pok.reshape(B, -1)[:, :cap]
    pad = cap - flat_idx.shape[1]
    if pad > 0:
        flat_idx = torch.nn.functional.pad(flat_idx, (0, pad))
        flat_rows = torch.nn.functional.pad(flat_rows, (0, pad))
        flat_ok = torch.nn.functional.pad(flat_ok, (0, pad))
    W = seq["xyz"].shape[-2]
    cell = flat_rows * W + flat_idx

    def take(ch):
        flat = ch.reshape(B, S * W, *ch.shape[3:])
        if flat.dim() == 3:
            return torch.gather(flat, 1, cell[..., None].expand(B, cap, flat.shape[-1]))
        return torch.gather(flat, 1, cell)

    pts = torch.where(flat_ok[..., None], take(seq["xyz"]), 0.0)
    out_rows = torch.where(flat_ok, flat_rows, -1).to(torch.int32)
    outs = [pts, flat_ok, out_rows]
    for ch in extra:
        outs.append(torch.where(flat_ok, take(ch), torch.zeros((), dtype=ch.dtype,
                                                                device=ch.device)))
    return tuple(outs)


def gather_masked(values, mask, cap: int):
    """Compact the masked cells of (B,S,W,C) values into (B,cap,C), in
    row-major order; overflow beyond cap is dropped, the rest zero-filled.
    Returns (out, out_mask)."""
    B = mask.shape[0]
    N = mask.shape[1] * mask.shape[2]
    flat_mask = mask.reshape(B, N)
    flat_vals = values.reshape(B, N, -1)
    ar = torch.arange(N, device=mask.device)
    order = torch.argsort(torch.where(flat_mask, ar, N + ar), dim=1)[:, :cap]
    out = torch.gather(flat_vals, 1, order[..., None].expand(B, order.shape[1],
                                                             flat_vals.shape[-1]))
    if cap > N:
        out = torch.nn.functional.pad(out, (0, 0, 0, cap - N))
    out_mask = torch.arange(cap, device=mask.device) < torch.sum(flat_mask, dim=1,
                                                                 keepdim=True)
    return torch.where(out_mask[..., None], out, torch.zeros_like(out)), out_mask


def _window_min(lab, dr: int, dc: int, fill: int):
    """Minimum of lab (B,S,W) over the (2 dr + 1) x (2 dc + 1) window of each
    cell, cells outside the image taken as fill: a column-wise, then a
    row-wise min of shifted copies (the same integers as the min over every
    shift of the window)."""
    S, W = lab.shape[-2:]
    p = torch.nn.functional.pad(lab, (dc, dc, dr, dr), value=fill)
    rows = p[..., 0:S, :]
    for k in range(1, 2 * dr + 1):
        rows = torch.minimum(rows, p[..., k:k + S, :])
    out = rows[..., 0:W]
    for k in range(1, 2 * dc + 1):
        out = torch.minimum(out, rows[..., k:k + W])
    return out


def combine_edges_hysteresis(strict_img, loose_img, h_size: int = 3,
                             v_size: int = 2, min_segment: int = 5,
                             iters: int = 10):
    """CombineEdgeFeatures (Velodyne.cpp:1191-1267): hysteresis between a
    strict and a loose edge image (B,S,W). The cells of either image are
    flooded with the minimum label over the (+-v_size, +-h_size) window for
    `iters` rounds, as the JAX package does; a label keeps its cells when it
    has >= min_segment of them and at least one strict cell.

    Returns (keep (B,S,W) bool, labels (B,S,W) int64, S*W where dropped)."""
    B, S, W = strict_img.shape
    mask = strict_img | loose_img
    big = S * W
    lin = torch.arange(big, device=mask.device).reshape(S, W)
    labels = torch.where(mask, lin, big)
    for _ in range(iters):
        labels = torch.where(mask, _window_min(labels, v_size, h_size, big), big)
    flat = labels.reshape(B, big)
    sizes = torch.zeros((B, big + 1), dtype=torch.int64, device=mask.device)
    sizes.scatter_add_(1, flat, mask.reshape(B, big).to(torch.int64))
    seeded = torch.zeros_like(sizes)
    seeded.scatter_reduce_(1, flat, strict_img.reshape(B, big).to(torch.int64),
                           reduce="amax")
    ok = (sizes >= min_segment) & (seeded > 0)
    keep = torch.gather(ok, 1, flat).reshape(B, S, W) & mask
    return keep, torch.where(keep, labels, big)


def _decimation_hash(cell):
    """Per-cell uniform in [0,1): uint32(cell * 2654435761) / 2^32, with
    the wrapping uint32 multiply emulated in int64 masked to 32 bits."""
    h = (cell.to(torch.int64) * 2654435761) & 0xFFFFFFFF
    return h.to(torch.float32) * f32(1.0 / 4294967296.0)


# ----------------------------------------------------------------------------
# top-level feature extraction
# ----------------------------------------------------------------------------

def extract_features(pts, mask, max_curvature: float = 5.0,
                     intersect_angle_threshold: float = 5.0,
                     segment: bool = True, method: int = 3,
                     repair_rings: bool = False):
    """Feature extraction (ExtractFeatures, Velodyne.cpp:531-769) for a
    batch of padded scans pts (B,P,3), mask (B,P). Returns a dict of the
    `ScanFeatures` fields, each with a leading scan axis (float32 points,
    bool masks, int32 rows and line labels)."""
    from . import lidar_lines

    # repair_rings: ReOrderVLP2's LCS conflict resolution (the variant the
    # reference uses where packet order may be corrupted, mvs/MVS.cpp:518)
    ring = repair_ring_conflicts(pts, mask) if repair_rings else None
    img = build_range_image(pts, mask, ring=ring)
    ground = mark_ground(img["xyz"], img["valid"])
    if segment:
        keep = segment_range_image(img["range"], img["valid"]) | ground
        img = {"valid": keep,
               "range": torch.where(keep, img["range"], 0.0),
               "xyz": torch.where(keep[..., None], img["xyz"], 0.0)}
    img["ground"] = ground & img["valid"]
    seq = compact_rows(img)

    curv, m, window_ok = adaptive_curvature(seq)
    vang = view_angles(seq)
    _, interior = _sector_ids(seq)

    edge_eligible = (
        interior & window_ok & ~seq["ground"]
        & (curv > f32(0.1)) & (curv <= f32(max_curvature))
        & (vang >= f32(intersect_angle_threshold))
        & (vang <= f32(180.0 - intersect_angle_threshold)))
    extents = _suppression_extents(seq["xyz"])
    picked_e, disabled, eidx, eok = greedy_pick(
        seq, curv, edge_eligible, 30, True, extents)

    hyst_keep = None
    if method == 2:
        # DOUBLE_EXTRACTION: a strict pick pass (a tenth of the curvature
        # bound, twice the angle margin) seeds the hysteresis over the loose
        # picks, both as range-image cells
        strict_eligible = (
            interior & window_ok & ~seq["ground"]
            & (curv > f32(0.1)) & (curv <= f32(max_curvature / 10.0))
            & (vang >= f32(2.0 * intersect_angle_threshold))
            & (vang <= f32(180.0 - 2.0 * intersect_angle_threshold)))
        picked_s, _, _, _ = greedy_pick(seq, curv, strict_eligible, 30, True, extents)
        W_img = seq["valid"].shape[-1]

        def to_image(picked):
            col = torch.where(picked & seq["valid"], seq["col"], W_img)
            img_ = torch.zeros(picked.shape[:-1] + (W_img + 1,), dtype=torch.bool,
                               device=picked.device)
            return img_.scatter_(-1, col, True)[..., :W_img]

        hyst_keep, _ = combine_edges_hysteresis(to_image(picked_s), to_image(picked_e))

    plane_eligible = (interior & window_ok & (curv >= 0) & (curv <= f32(0.02))
                      & ~picked_e & ~disabled)
    picked_f, disabled_f, fidx, fok = greedy_pick(
        seq, curv, plane_eligible, 4, False, extents)
    all_disabled = disabled | disabled_f
    less_flat_sw = (interior & window_ok & (curv >= 0) & (curv < f32(0.3))
                    & ~picked_e & ~picked_f & ~all_disabled)

    B, S, W = seq["valid"].shape
    rows = torch.arange(S, device=pts.device)[:, None].expand(S, W)
    if hyst_keep is not None:
        # the hysteresis-validated cells, gathered from the image grid in
        # row-major order, their rows carried as row + 0.5
        pack = torch.cat([img["xyz"], (rows.to(torch.float32) + 0.5)
                          .expand(B, S, W)[..., None]], dim=-1)
        g, edge_mask = gather_masked(pack, hyst_keep & img["valid"], CAP_EDGE)
        edge_pts = g[..., :3]
        edge_rows = torch.where(edge_mask, g[..., 3].to(torch.int32), -1)
    else:
        edge_pts, edge_mask, edge_rows = picks_to_buffer(seq, eidx, eok, CAP_EDGE)
    sharp_pts, sharp_mask, _ = picks_to_buffer(seq, eidx[:, :3], eok[:, :3],
                                               CAP_SHARP)
    flat_pts, flat_mask, flat_rows, flat_grd = picks_to_buffer(
        seq, fidx, fok, CAP_FLAT, extra=(seq["ground"],))

    # surf points: keep each cell with probability ~ r^2 (the range image is
    # an angular grid, cell footprint grows ~r^2), decided by a per-cell
    # hash, rescaled to the CAP_SURF budget (stands in for the reference's
    # 0.2 m pcl::VoxelGrid, Velodyne.cpp:1076-1080)
    r = seq["range"]
    p_base = torch.clamp_max(r * r * f32(1.218e-4 / 0.04), 1.0)
    expect = torch.sum(torch.where(less_flat_sw, p_base, 0.0), dim=(1, 2))
    scale = rdiv(f32(0.92 * CAP_SURF), torch.clamp_min(expect, 1.0))
    p = torch.clamp_max(p_base * scale[:, None, None], 1.0)
    h01 = _decimation_hash(rows * W + seq["col"])
    keep_sw = less_flat_sw & (h01 < p)
    lf_pack = torch.stack([
        seq["xyz"][..., 0], seq["xyz"][..., 1], seq["xyz"][..., 2],
        rows.expand(B, S, W).to(torch.float32), seq["ground"].to(torch.float32)],
        dim=-1)
    lf_g, lf_mask = gather_masked(lf_pack, keep_sw, CAP_SURF)
    lf_rows = torch.where(lf_mask, lf_g[..., 3].to(torch.int32), -1)

    lines = lidar_lines.extract_lines(edge_pts, edge_mask, edge_rows)
    on_line = lines["point_label"] >= 0
    return {
        "sharp": sharp_pts, "sharp_mask": sharp_mask,
        "less_sharp": edge_pts, "less_sharp_mask": edge_mask & on_line,
        "less_sharp_row": edge_rows,
        "point_to_segment": lines["point_label"],
        "flat": flat_pts, "flat_mask": flat_mask,
        "flat_ground": flat_grd, "flat_row": flat_rows,
        "less_flat": lf_g[..., :3], "less_flat_mask": lf_mask,
        "less_flat_ground": lf_g[..., 4] > 0.5,
        "less_flat_row": lf_rows,
        "line_points": lines["points"], "line_dirs": lines["dirs"],
        "line_endpoints": lines["endpoints"], "line_mask": lines["mask"],
    }


# ----------------------------------------------------------------------------
# voxel grid (panovlm_tpu/sensors/velodyne.py:784-832)
# ----------------------------------------------------------------------------

def voxel_downsample(pts, mask, aux=None, leaf: float = 0.2, weights=None,
                     return_counts: bool = False):
    """Centroid voxel-grid filter (pcl::VoxelGrid, Velodyne.cpp:1076-1080).
    pts (N,3), mask (N,). Returns (centroids (N,3), out_mask (N,)): one
    entry per occupied voxel in ascending key order (a stable sort, as
    jnp.argsort is), padded with zeros. aux (N,) or (N,A) is averaged per
    voxel too (returned third); weights (N,) make the means weighted;
    return_counts appends the per-voxel weight sums. The per-voxel sums are
    exact (`ops/exact.index_sum`), so the centroids do not change from run
    to run on the card (ROADMAP F9)."""
    n = pts.shape[0]
    vox = torch.floor(pts / leaf).to(torch.int32)
    vmin = torch.min(torch.where(mask[:, None], vox, torch.full_like(vox, 2**30)), dim=0).values
    # 10-bit packed exact key (1024 cells per axis; farther points clip
    # into the boundary voxel)
    v = torch.clamp(vox - vmin, 0, 1023)
    key = (v[:, 0] << 20) | (v[:, 1] << 10) | v[:, 2]
    key = torch.where(mask, key, torch.full_like(key, 2**30))
    order = torch.sort(key, stable=True).indices
    ks, ps, ms = key[order], pts[order], mask[order]
    if weights is None:
        ws = ms.to(pts.dtype)
    else:
        ws = torch.where(ms, weights.to(pts.dtype)[order], torch.zeros_like(ps[:, 0]))
    first = torch.ones(1, dtype=torch.bool, device=pts.device)
    uniq = torch.cat([first, ks[1:] != ks[:-1]]) & ms
    seg = torch.clamp_min(torch.cumsum(uniq.to(torch.int64), 0) - 1, 0)
    n_vox = int(uniq.sum())
    rows = max(1, n_vox)

    def voxel_sum(src):
        """Exact per-voxel sums, their int64 words sized to the occupied
        voxels, padded with zeros to n rows."""
        out = src.new_zeros((n, *src.shape[1:]))
        out[:rows] = exact.index_sum(rows, seg, src)
        return out

    sums = voxel_sum(ws[:, None] * ps)
    cnts = voxel_sum(ws)
    out_mask = torch.arange(n, device=pts.device) < n_vox
    safe = torch.clamp_min(cnts, 1e-9)[:, None]
    centroids = torch.where(out_mask[:, None], sums / safe, torch.zeros_like(sums))
    out_cnts = torch.where(out_mask, cnts, torch.zeros_like(cnts))
    if aux is None:
        return (centroids, out_mask, out_cnts) if return_counts \
            else (centroids, out_mask)
    aux2 = aux.to(pts.dtype)
    squeeze = aux2.dim() == 1
    if squeeze:
        aux2 = aux2[:, None]
    aux_sum = voxel_sum(ws[:, None] * aux2[order])
    aux_out = torch.where(out_mask[:, None], aux_sum / safe, torch.zeros_like(aux_sum))
    aux_out = aux_out[:, 0] if squeeze else aux_out
    if return_counts:
        return centroids, out_mask, aux_out, out_cnts
    return centroids, out_mask, aux_out
