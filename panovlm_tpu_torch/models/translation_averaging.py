"""Global translation averaging — the port of
panovlm_tpu/models/translation_averaging.py (sfm/TranslationAveraging.{h,cpp},
sfm/BATA.{h,cpp} and sfm/LinearProgramming.{h,cpp} of the reference), all
six methods:

  * DLT init: linear least squares over global translations and pair
    scales, CG on the normal equations;
  * L2 / SoftL1 / L2IRLS: PairWiseTranslationResidual plus soft scale
    bounds around the initial scales, one LM solve (IRLS: a few Huber
    solves with a shrinking scale);
  * Chordal (1DSfM) and LUD: residuals on camera centres against the
    world-frame baseline directions; LUD adds the soft bound s >= 1;
  * BATA: its IRLS form, 20 outer rounds of 50 CG steps with
    Geman-McClure weights;
  * L1: the L-infinity LP over triplet-supported pairs on the host
    (scipy's HiGHS, as in the JAX package), then three Huber polishes.

The LM solves run on the card's tiers (dense, Schur or PCG by JAX's rule);
parameters {"t": (N,3) global t_fw, or camera centres for chordal and LUD,
"s": (M,1) pair scales}, rotations held fixed. Scattered sums go through
`ops/exact.index_sum` (ROADMAP F9).
"""

from __future__ import annotations

import logging

import numpy as np
import torch
from scipy.spatial.transform import Rotation as ScR

from ..ops.exact import index_sum
from ..solver import residuals
from ..solver.lm import LMOptions, ResidualBlock, solve_lm
from ..utils import graph as graph_mod

log = logging.getLogger("panovlm")


def _measurement_dirs(aa_global, pair_j, rel_t):
    """Per-pair unit translation t_ji and the world-frame baseline direction
    dir_w = normalize(R_wj t_ji) that chordal, LUD and BATA use; float32."""
    rel_t_u = np.asarray(rel_t, np.float64)
    rel_t_u = rel_t_u / (np.linalg.norm(rel_t_u, axis=1, keepdims=True) + 1e-12)
    R_jw = ScR.from_rotvec(np.asarray(aa_global)[np.asarray(pair_j)]).as_matrix()
    dir_w = np.einsum("mji,mj->mi", R_jw, rel_t_u)  # R_wj = R_jw^T
    dir_w /= np.linalg.norm(dir_w, axis=1, keepdims=True) + 1e-12
    return rel_t_u.astype(np.float32), dir_w.astype(np.float32)


def translation_averaging_dlt(aa_global, pair_i, pair_j, rel_aa, rel_t,
                              mask=None, cg_iters: int = 200, device="cpu"):
    """TranslationAveragingDLT (:31-84): min sum |t_j - R_ji t_i - s u|^2 with
    t_0 = 0, scales around 1, by CG on the Tikhonov-damped normal
    equations (lam 1e-6). Returns (t (N,3), s (M,)) numpy."""
    n, m = len(aa_global), len(pair_i)
    if mask is None:
        mask = np.ones(m, bool)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)
    u = t(_measurement_dirs(aa_global, pair_j, rel_t)[0])
    Rji = t(ScR.from_rotvec(np.asarray(rel_aa)).as_matrix().astype(np.float32))
    pi, pj = t(np.asarray(pair_i, np.int64)), t(np.asarray(pair_j, np.int64))
    w = t(np.asarray(mask, np.float32))

    def At(r):
        gt = index_sum(n, torch.cat([pj, pi]),
                       torch.cat([r, -torch.einsum("mji,mj->mi", Rji, r)]))
        gt[0] = 0.0
        return gt, -torch.sum(r * u, dim=1)

    def AtA(x):
        tt, s = x
        r = (tt[pj] - torch.einsum("mij,mj->mi", Rji, tt[pi]) - s[:, None] * u) * w[:, None]
        return At(r)

    r0 = (-u) * w[:, None]
    bt, bs = At(r0)
    b = (-bt, -bs)

    def dot(a, c):
        return torch.sum(a[0] * c[0]) + torch.sum(a[1] * c[1])

    lam = 1e-6
    x = (torch.zeros((n, 3), device=device), torch.zeros(m, device=device))
    r, p = b, b
    rs = dot(r, r)
    rs0 = float(rs)
    for _ in range(cg_iters):
        Ap = AtA(p)
        Ap = (Ap[0] + lam * p[0], Ap[1] + lam * p[1])
        alpha = rs / (dot(p, Ap) + 1e-30)
        x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
        r = (r[0] - alpha * Ap[0], r[1] - alpha * Ap[1])
        rs_new = dot(r, r)
        beta = rs_new / (rs + 1e-30)
        p = (r[0] + beta * p[0], r[1] + beta * p[1])
        rs = rs_new
        if float(rs) < 1e-14 * rs0 + 1e-30:
            break
    tt = x[0].cpu().numpy()
    s = x[1].cpu().numpy() + 1.0
    if np.median(s[np.asarray(mask)]) < 0:
        tt, s = -tt, -s
    return tt.astype(np.float32), s.astype(np.float32)


def _ta_solver(aa_global, pair_i, pair_j, rel_aa, rel_t, t0, s0, mask, loss,
               loss_scale, upper_scale_ratio=1.3, lower_scale_ratio=0.9,
               scale_weight=1.0, max_iters=40, use_lud=False, use_chordal=False,
               device="cpu"):
    """One LM solve: PairWiseTranslationResidual + soft scale bounds around
    s0 (L2 / SoftL1 / L2IRLS), or the chordal or LUD residual on camera
    centres C = -R_fw^T t_fw (LUD with the soft bound s >= 1 at weight 10)."""
    m = len(pair_i)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    rel_t_u, dir_w = _measurement_dirs(aa_global, pair_j, rel_t)
    centres = use_lud or use_chordal
    if centres:
        R_fw = ScR.from_rotvec(np.asarray(aa_global)).as_matrix()
        t0 = -np.einsum("nji,nj->ni", R_fw, np.asarray(t0))
    fixed_t = np.zeros((len(t0), 3), bool)
    fixed_t[0] = True
    pi, pj = t(pair_i, torch.int64), t(pair_j, torch.int64)
    ar = t(np.arange(m), torch.int64)
    msk = t(mask, torch.bool)
    ones = torch.ones(m, device=device)
    if use_chordal:
        blocks = (ResidualBlock(residuals.chordal, ("t", "t"), (pi, pj), (t(dir_w),), ones,
                                msk, loss=loss, loss_scale=loss_scale, name="chordal"),)
    elif use_lud:
        blocks = (
            ResidualBlock(residuals.lud, ("t", "t", "s"), (pi, pj, ar), (t(dir_w),), ones,
                          msk, loss=loss, loss_scale=loss_scale, name="lud"),
            ResidualBlock(residuals.scale_factor, ("s",), (ar,),
                          (ones, torch.full((m,), 1e6, device=device)),
                          torch.full((m,), 10.0, device=device), msk, name="scale_lb"))
    else:
        blocks = (
            ResidualBlock(residuals.pairwise_translation, ("t", "t", "s"), (pi, pj, ar),
                          (t(rel_aa), t(rel_t_u)), ones, msk, loss=loss,
                          loss_scale=loss_scale, name="pairwise_t"),
            ResidualBlock(residuals.scale_factor, ("s",), (ar,),
                          (t(np.asarray(s0) * lower_scale_ratio),
                           t(np.asarray(s0) * upper_scale_ratio)),
                          torch.full((m,), scale_weight, device=device), msk,
                          name="scale_bounds"))
    out, info = solve_lm({"t": t(t0), "s": t(s0).reshape(-1, 1)}, blocks,
                         {"t": t(fixed_t, torch.bool),
                          "s": torch.zeros((m, 1), dtype=torch.bool, device=device)},
                         LMOptions(max_iters=max_iters))
    t_out = out["t"].cpu().numpy()
    if centres:
        t_out = -np.einsum("nij,nj->ni", R_fw, t_out)
    return t_out, out["s"][:, 0].cpu().numpy(), info


def translation_averaging_bata(aa_global, pair_i, pair_j, rel_aa, rel_t, t0, mask,
                               iters: int = 20, delta: float = 0.05, device="cpu"):
    """BATA (baseline-desensitized TA, CVPR'18; sfm/BATA.cpp): alternate the
    per-edge projective scale theta_ij = (d . dC) / |dC|^2 with a
    Geman-McClure-reweighted linear solve for the camera centres (50 CG
    steps, C_0 pinned), then rescale the mean projected baseline to 1.
    Returns (t (N,3), s (M,)) float32 numpy."""
    n = len(aa_global)
    R_fw = ScR.from_rotvec(np.asarray(aa_global)).as_matrix()

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    C = t(-np.einsum("nji,nj->ni", R_fw, np.asarray(t0)))
    d = t(_measurement_dirs(aa_global, pair_j, rel_t)[1])
    pi, pj = t(pair_i, torch.int64), t(pair_j, torch.int64)
    both = torch.cat([pi, pj])
    msk = t(mask)

    def scatter(v):
        """sum_ij v_ij e_i - v_ij e_j, row 0 zeroed (the pinned centre)."""
        g = index_sum(n, both, torch.cat([v, -v]))
        g[0] = 0.0
        return g

    for _ in range(iters):
        dC = C[pi] - C[pj]
        theta = (torch.clamp_min(torch.sum(d * dC, dim=1), 1e-6)
                 / torch.clamp_min(torch.sum(dC * dC, dim=1), 1e-9))
        e = d - theta[:, None] * dC
        w = msk / (torch.sum(e * e, dim=1) + delta * delta)
        wtt = (w * theta * theta)[:, None]

        def Ax(x):
            return scatter((x[pi] - x[pj]) * wtt)

        x = C.clone()
        x[0] = 0.0
        r = scatter((w * theta)[:, None] * d) - Ax(x)
        p = r
        rs = torch.sum(r * r)
        for _ in range(50):
            Ap = Ax(p)
            alpha = rs / (torch.sum(p * Ap) + 1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            rs_new = torch.sum(r * r)
            p = r + (rs_new / (rs + 1e-30)) * p
            rs = rs_new
        scale = torch.sum(msk * torch.sum(d * (x[pi] - x[pj]), dim=1)) / torch.clamp_min(
            msk.sum(), 1)
        C = x / torch.clamp_min(torch.abs(scale), 1e-9)
    C_np = C.cpu().numpy().astype(np.float64)
    tt = -np.einsum("nij,nj->ni", R_fw, C_np)
    s = np.linalg.norm(C_np[np.asarray(pair_j)] - C_np[np.asarray(pair_i)], axis=1)
    return tt.astype(np.float32), s.astype(np.float32)


def linf_triplets(pair_i, pair_j, mask, max_triplets: int = 20000):
    """The triangles of the masked pair graph in networkx's edge order, each
    once as a sorted (a, b, c), cut to max_triplets evenly by linspace; and
    {(i, j): pair row} (the last row of a repeated pair). Returns
    (triplets, edge_of, count before the cut)."""
    g = graph_mod.Graph()
    edge_of = {}
    for k in range(len(pair_i)):
        if mask[k]:
            a, b = int(pair_i[k]), int(pair_j[k])
            g.add_edge(a, b)
            edge_of[(a, b)] = k
    triplets = [tuple(sorted((a, b, c))) for a, b in g.edges()
                for c in sorted(graph_mod.common_neighbors(g, a, b)) if c > max(a, b)]
    found = len(triplets)
    if found > max_triplets:
        sel = np.linspace(0, found - 1, max_triplets).astype(int)
        triplets = [triplets[s] for s in sel]
    return triplets, edge_of, found


def translation_averaging_linf_lp(aa_global, pair_i, pair_j, rel_aa, rel_t, mask,
                                  origin_idx: int = 0, max_triplets: int = 20000):
    """The L-infinity LP over triplet-supported pairs (TranslationAveragingL1,
    sfm/TranslationAveraging.cpp:277-417): minimize gamma subject to
    |t_j - R_ji t_i - lambda_ij u_ij| <= gamma per axis for every pair in a
    triangle of the pair graph, lambda_ij >= 1 (one per pair, as in the JAX
    package), the origin camera at 0; scipy's HiGHS on the host. Returns
    (t (N,3) float32, True), or (None, False) without triplets or when the
    LP fails."""
    from scipy.optimize import linprog
    from scipy.sparse import coo_matrix

    pi, pj, mask = np.asarray(pair_i), np.asarray(pair_j), np.asarray(mask)
    n = len(np.asarray(aa_global))
    triplets, edge_of, found = linf_triplets(pi, pj, mask, max_triplets)
    if not triplets:
        return None, False
    if found > max_triplets:
        log.info("L-inf LP: sampled %d of %d triplets", max_triplets, found)
    R = ScR.from_rotvec(np.asarray(rel_aa, np.float64)).as_matrix()
    t_u = np.asarray(rel_t, np.float64)
    t_u = t_u / (np.linalg.norm(t_u, axis=1, keepdims=True) + 1e-12)

    supported = sorted({edge_of[(i, j) if (i, j) in edge_of else (j, i)]
                        for (a, b, c) in triplets
                        for (i, j) in ((a, b), (b, c), (a, c))})
    n_lam = len(supported)
    lam0 = 3 * n
    gamma = lam0 + n_lam
    rows, cols, vals = [], [], []
    r = 0
    for lidx, k in enumerate(supported):
        i, j = int(pi[k]), int(pj[k])
        R21, u21 = R[k], t_u[k]
        for axis in range(3):
            for sign in (1.0, -1.0):
                rows += [r] * 6
                cols += [3 * j + axis, 3 * i + 0, 3 * i + 1, 3 * i + 2, lam0 + lidx, gamma]
                vals += [sign, -sign * R21[axis, 0], -sign * R21[axis, 1],
                         -sign * R21[axis, 2], -sign * u21[axis], -1.0]
                r += 1
    A = coo_matrix((vals, (rows, cols)), shape=(r, gamma + 1))
    cost = np.zeros(gamma + 1)
    cost[gamma] = 1.0
    bounds = [(None, None)] * (3 * n)
    for axis in range(3):
        bounds[3 * origin_idx + axis] = (0.0, 0.0)
    bounds += [(1.0, None)] * n_lam + [(0.0, None)]
    res = linprog(cost, A_ub=A.tocsr(), b_ub=np.zeros(r), bounds=bounds, method="highs")
    if not res.success:
        log.warning("L-inf LP failed: %s", res.message)
        return None, False
    return res.x[:3 * n].reshape(n, 3).astype(np.float32), True


def translation_averaging(aa_global, pair_i, pair_j, rel_aa, rel_t, scales,
                          mask=None, method: str = "softl1",
                          upper_scale_ratio=1.3, lower_scale_ratio=0.9,
                          t_init=None, irls_iters: int = 3, lp_triplets: int = 20000,
                          device="cpu"):
    """EstimateGlobalTranslation (sfm/SfM.cpp:1047-1344): the DLT init (or
    `t_init`, the init_translation_GPS path, :1218-1240, with the unmeasured
    scales set to the median measured one), one of the averaging methods,
    then the scale gauge re-anchored so the measured pair scales hold on
    median. lp_triplets: the most triplets "l1"'s L-infinity LP samples.
    Returns (t_fw (N,3), s (M,)) float32."""
    m = len(pair_i)
    if mask is None:
        mask = np.ones(m, bool)
    scales = np.asarray(scales)
    if t_init is not None:
        t0 = np.asarray(t_init, np.float32)
        fallback = float(np.median(scales[scales > 0])) if (scales > 0).any() else 1.0
        s_dlt = np.where(scales > 0, scales, fallback).astype(np.float32)
    else:
        t0, s_dlt = translation_averaging_dlt(aa_global, pair_i, pair_j, rel_aa, rel_t,
                                              mask, device=device)
    s0 = np.where(scales > 0, scales, np.abs(s_dlt) + 1e-3)
    if method == "dlt":
        return t0, s_dlt
    common = dict(aa_global=aa_global, pair_i=pair_i, pair_j=pair_j,
                  rel_aa=rel_aa, rel_t=rel_t, t0=t0, s0=s0, mask=mask,
                  upper_scale_ratio=upper_scale_ratio,
                  lower_scale_ratio=lower_scale_ratio, device=device)
    if method == "l2":
        t, s, _ = _ta_solver(loss="trivial", loss_scale=1.0, **common)
    elif method == "softl1":
        t, s, _ = _ta_solver(loss="soft_l1", loss_scale=0.1, **common)
    elif method == "l2irls":
        t, s = t0, s0
        for sc in np.geomspace(1.0, 0.1, max(int(irls_iters), 2)):
            common["t0"], common["s0"] = t, s
            t, s, _ = _ta_solver(loss="huber", loss_scale=float(sc), max_iters=15,
                                 **common)
    elif method == "chordal":
        t, _, _ = _ta_solver(loss="huber", loss_scale=0.1, use_chordal=True, **common)
        s = s0
    elif method == "lud":
        # the s >= 1 soft bound sets the gauge: scales normalised by their median
        common["s0"] = np.maximum(np.abs(s0) / (np.median(np.abs(s0)) + 1e-9), 1.0)
        t, s, _ = _ta_solver(loss="soft_l1", loss_scale=0.05, use_lud=True, **common)
    elif method == "bata":
        t, s = translation_averaging_bata(aa_global, pair_i, pair_j, rel_aa, rel_t, t0,
                                          mask, device=device)
    elif method == "l1":
        # the LP's translations polished by three Huber solves; the init
        # (DLT or GPS) when the graph has no triplets or the LP fails
        t_lp, lp_ok = translation_averaging_linf_lp(aa_global, pair_i, pair_j, rel_aa,
                                                    rel_t, mask, max_triplets=lp_triplets)
        t, s = (t_lp, s0) if lp_ok else (t0, s0)
        for sc in (0.1, 0.03, 0.01):
            common["t0"], common["s0"] = t, s
            t, s, _ = _ta_solver(loss="huber", loss_scale=sc, max_iters=15, **common)
    else:
        raise ValueError(f"unknown method {method}")
    measured = scales > 0
    if measured.any():
        alpha = float(np.median(s0[measured] / np.maximum(np.abs(s[measured]), 1e-9)))
        t, s = t * alpha, s * alpha
    return t.astype(np.float32), s.astype(np.float32)
