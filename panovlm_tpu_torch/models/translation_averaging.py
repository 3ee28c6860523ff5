"""Global translation averaging — the port of the DLT init and the
pairwise-translation methods of panovlm_tpu/models/translation_averaging.py
(sfm/TranslationAveraging.{h,cpp} of the reference): parameters
{"t": (N,3) global t_fw, "s": (M,1) pair scales}, rotations held fixed,
PairWiseTranslationResidual plus soft scale bounds around the initial
scales, solved by the dense LM (L2, SoftL1, L2IRLS).

Not ported, each raising NotImplementedError that names ROADMAP.md: the
chordal, LUD, BATA and L-infinity LP (method "l1") solvers, and the GPS
translation init.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation as ScR

from ..ops.exact import index_sum
from ..solver import residuals
from ..solver.lm import LMOptions, ResidualBlock, solve_lm

NOT_PORTED = ("l1", "chordal", "bata", "lud")


def _unit_dirs(rel_t):
    u = np.asarray(rel_t, np.float64)
    return (u / (np.linalg.norm(u, axis=1, keepdims=True) + 1e-12)).astype(np.float32)


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
    u = t(_unit_dirs(rel_t))
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
               scale_weight=1.0, max_iters=40, device="cpu"):
    """PairWiseTranslationResidual + soft scale bounds, one LM solve."""
    m = len(pair_i)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    fixed_t = np.zeros((len(t0), 3), bool)
    fixed_t[0] = True
    ar = t(np.arange(m), torch.int64)
    msk = t(mask, torch.bool)
    blocks = (
        ResidualBlock(residuals.pairwise_translation, ("t", "t", "s"),
                      (t(pair_i, torch.int64), t(pair_j, torch.int64), ar),
                      (t(rel_aa), t(_unit_dirs(rel_t))),
                      torch.ones(m, device=device), msk, loss=loss,
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
    return out["t"].cpu().numpy(), out["s"][:, 0].cpu().numpy(), info


def translation_averaging(aa_global, pair_i, pair_j, rel_aa, rel_t, scales,
                          mask=None, method: str = "softl1",
                          upper_scale_ratio=1.3, lower_scale_ratio=0.9,
                          t_init=None, irls_iters: int = 3, device="cpu"):
    """EstimateGlobalTranslation (sfm/SfM.cpp:1047-1344): DLT init, one of
    the averaging methods, then the scale gauge re-anchored so the measured
    pair scales hold on median. Returns (t_fw (N,3), s (M,)) float32."""
    if method in NOT_PORTED:
        raise NotImplementedError(
            f"translation averaging method {method!r} is not ported; use softl1, "
            "l2 or l2irls (ROADMAP.md)")
    if t_init is not None:
        raise NotImplementedError("the GPS translation init is not ported (ROADMAP.md)")
    m = len(pair_i)
    if mask is None:
        mask = np.ones(m, bool)
    t0, s_dlt = translation_averaging_dlt(aa_global, pair_i, pair_j, rel_aa, rel_t,
                                          mask, device=device)
    scales = np.asarray(scales)
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
    else:
        raise ValueError(f"unknown method {method}")
    measured = scales > 0
    if measured.any():
        alpha = float(np.median(s0[measured] / np.maximum(np.abs(s[measured]), 1e-9)))
        t, s = t * alpha, s * alpha
    return t.astype(np.float32), s.astype(np.float32)
