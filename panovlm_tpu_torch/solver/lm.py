"""Levenberg-Marquardt, dense tier — ported from `panovlm_tpu/solver/lm.py`.

Same algorithm as the JAX solver's dense path (`lm.py:686-851`): residual
families are ResidualBlocks (one per-observation function mapped over the
observation axis, with validity masks); robust losses enter as IRLS weights
sqrt(rho'(s)) frozen per iteration; the whitened normal equations
H = J^T J are assembled densely (run-length sums before the scatter), damped
by lam * (diag(H) + eps) and solved by Cholesky; lambda follows Nielsen's
rule; gauge-fixed coordinates are projected out.

PyTorch idiom: the LM loop is a Python loop whose exit test reads one flag
per iteration; Jacobians come from `torch.func.vmap(jacrev)` over the
valid observation rows only (masked rows contribute exactly zero, so they
are dropped up front instead of being evaluated and zeroed). The JAX
package's observation chunking (`obs_chunk`/`jac_chunk`) exists for TPU
lane padding and is not carried over.

The Schur tier (`lm.py:404-647`, `solve_lm(schur=...)`): a group that one
block references once per observation (the BA points) is eliminated per
point, and the reduced system over the other groups is solved densely. The
JAX module lays the points out as padded (T, L) tracks and buckets short
and long ones (`bucket_schur_points`); here the valid rows are ragged, and
the reduced matrix sum_t U_t V_t^-1 U_t^T is scattered from the pairs of
rows that share a point, in chunks of `_SCHUR_PAIR_CHUNK` pairs. Problems
whose dense (or reduced) system has more than `dense_max_params`
parameters raise: the PCG tier is not ported (ROADMAP.md).

Every scattered sum (gradients, Hessian blocks, the Schur complement) goes
through `ops/exact.index_sum`: float `index_add_` on the card adds
with atomics in a varying order, and the solve amplifies its last-bit
differences into different poses from run to run (ROADMAP F9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch.func import jacrev, vmap

from ..ops.exact import index_sum
from . import robust

_SCHUR_PAIR_CHUNK = 1 << 21   # row pairs per scatter into the reduced matrix


@dataclass
class ResidualBlock:
    """One residual family: fn(*params, *data) -> (r_dim,) for one
    observation. params are the rows of the groups in `groups` picked by
    `indices` (one (M,) index tensor per group argument); data are (M, ...)
    per-observation constants. `run_length` > 1 promises that every index
    tensor is constant over consecutive runs of that length (the pair x
    point layout of the LiDAR blocks), so Hessian blocks are summed per run
    before they are scattered."""
    fn: Callable
    groups: tuple
    indices: tuple
    data: tuple
    weight: torch.Tensor
    mask: torch.Tensor
    loss: str = robust.TRIVIAL
    loss_scale: float = 1.0
    name: str = ""
    run_length: int = 1


class LMOptions(NamedTuple):
    max_iters: int = 20          # reference SetOptionsLidar: 20
    ftol: float = 1e-9
    init_lambda: float = 1e-4
    max_lambda: float = 1e10
    min_lambda: float = 1e-12
    dense_max_params: int = 6144


def _flat_layout(groups: dict):
    """Deterministic flattening of {g: (N, W)} into one P-vector."""
    offs, P = {}, 0
    for g in sorted(groups):
        N, W = groups[g].shape
        offs[g] = P
        P += N * W
    return offs, P


class _Rows(NamedTuple):
    """The valid observation rows of one block, gathered once per solve
    (masked rows contribute exactly zero, so they are never evaluated)."""
    block: ResidualBlock
    indices: tuple        # per group argument, (m,) int64 parameter rows
    data: tuple           # (m, ...) per-observation constants
    weight: torch.Tensor  # (m,)
    run: torch.Tensor | None    # (m,) run of each row, None without runs
    run_first: torch.Tensor | None  # (R,) first row of each run


def _valid_rows(block: ResidualBlock) -> _Rows:
    rows = torch.nonzero(block.mask, as_tuple=True)[0]
    run = run_first = None
    rl = block.run_length
    if rl > 1 and block.mask.shape[0] % rl == 0:
        _, run, counts = torch.unique_consecutive(
            torch.div(rows, rl, rounding_mode="floor"),
            return_inverse=True, return_counts=True)
        run_first = torch.cumsum(counts, 0) - counts
    return _Rows(block, tuple(i[rows].long() for i in block.indices),
                 tuple(d[rows] for d in block.data), block.weight[rows],
                 run, run_first)


def _params(rows: _Rows, x: dict):
    return [x[g][i] for g, i in zip(rows.block.groups, rows.indices)]


def _finite(r):
    """Non-finite -> 0 (Ceres drops residual blocks it cannot evaluate)."""
    return torch.where(torch.isfinite(r), r, torch.zeros_like(r))


def _block_cost(block: ResidualBlock, r):
    s = torch.sum(r * r, dim=-1)
    return 0.5 * torch.sum(robust.rho(block.loss, s, block.loss_scale)), s


def _total_cost(x: dict, all_rows) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=next(iter(x.values())).device)
    for rows in all_rows:
        if rows.weight.numel():
            r = _finite(vmap(rows.block.fn)(*_params(rows, x), *rows.data)
                        * rows.weight[:, None])
            total = total + _block_cost(rows.block, r)[0]
    return total


def _linearize(x: dict, all_rows, offs: dict, P: int):
    """Cost, gradient g = J^T F and dense H = J^T J of the IRLS-whitened
    residual vector F at x."""
    dev = next(iter(x.values())).device
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    g = torch.zeros(P, dtype=torch.float32, device=dev)
    Hf = torch.zeros(P * P, dtype=torch.float32, device=dev)
    for rows in all_rows:
        block = rows.block
        if rows.weight.numel() == 0:
            continue

        def fn_aux(*args):
            r = block.fn(*args)
            return r, r

        Js, r = vmap(jacrev(fn_aux, argnums=tuple(range(len(block.groups))),
                            has_aux=True))(*_params(rows, x), *rows.data)
        r = _finite(r * rows.weight[:, None])
        c, s = _block_cost(block, r)
        cost = cost + c
        w = torch.sqrt(robust.rho_prime(block.loss, s, block.loss_scale))
        scale = (rows.weight * w)[:, None, None]
        J = torch.cat([_finite(Jk) * scale for Jk in Js], dim=-1)   # (m, r_dim, sum W)
        fidx = torch.cat([offs[gr] + i[:, None] * Jk.shape[-1]
                          + torch.arange(Jk.shape[-1], device=dev)
                          for gr, i, Jk in zip(block.groups, rows.indices, Js)],
                         dim=-1)                                     # (m, sum W)
        g = g + index_sum(P, fidx.reshape(-1),
                          torch.einsum("mri,mr->mi", J, r * w[:, None]).reshape(-1))
        outer = torch.einsum("mri,mrj->mij", J, J)      # (m, sum W, sum W)
        if rows.run is not None:   # sum each run before the scatter
            outer = index_sum(rows.run_first.shape[0], rows.run, outer)
            fidx = fidx[rows.run_first]
        flat = fidx[:, :, None] * P + fidx[:, None, :]
        Hf = Hf + index_sum(P * P, flat.reshape(-1), outer.reshape(-1))
    return cost, g, Hf.reshape(P, P)


def _inv3(A):
    """Closed-form inverse of (..., 3, 3) blocks (adjugate / determinant)."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    adj = torch.stack([torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
                       torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
                       torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1)], -2)
    det = a * adj[..., 0, 0] + b * adj[..., 1, 0] + c * adj[..., 2, 0]
    return adj / det[..., None, None]


def _schur_linearize(x: dict, all_rows, offs_r: dict, Pr: int, eg: str, free: dict):
    """Cost, the rest groups' gradient (Pr,) and dense H (Pr, Pr), the
    eliminated group's gradient (T, WE), and for its block: per valid row
    the point index, J_E (m, r, WE), U = J_rest^T J_E (m, Wr, WE) and the
    flat rest-parameter ids (m, Wr). Fixed coordinates of the rest groups
    are zeroed in U, those of the points in J_E (as `_schur_pass` does)."""
    dev = next(iter(x.values())).device
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    g_r = torch.zeros(Pr, dtype=torch.float32, device=dev)
    Hf = torch.zeros(Pr * Pr, dtype=torch.float32, device=dev)
    gE = torch.zeros_like(x[eg])
    part = None
    for rows in all_rows:
        block = rows.block
        if rows.weight.numel() == 0:
            continue

        def fn_aux(*args):
            r = block.fn(*args)
            return r, r

        Js, r = vmap(jacrev(fn_aux, argnums=tuple(range(len(block.groups))),
                            has_aux=True))(*_params(rows, x), *rows.data)
        r = _finite(r * rows.weight[:, None])
        c, s = _block_cost(block, r)
        cost = cost + c
        w = torch.sqrt(robust.rho_prime(block.loss, s, block.loss_scale))
        scale = (rows.weight * w)[:, None, None]
        Js = [_finite(Jk) * scale for Jk in Js]
        rw = r * w[:, None]
        rest = [k for k, gname in enumerate(block.groups) if gname != eg]
        fids = {}
        for k, (gname, idx) in enumerate(zip(block.groups, rows.indices)):
            gk = torch.einsum("mri,mr->mi", Js[k], rw)
            if gname == eg:
                gE = gE + index_sum(gE.shape[0], idx, gk)
            else:
                Wk = Js[k].shape[-1]
                fids[k] = offs_r[gname] + idx[:, None] * Wk + torch.arange(Wk, device=dev)
                g_r = g_r + index_sum(Pr, fids[k].reshape(-1), gk.reshape(-1))
        if not rest:
            continue
        J = torch.cat([Js[k] for k in rest], dim=-1)
        fidx = torch.cat([fids[k] for k in rest], dim=-1)
        outer = torch.einsum("mri,mrj->mij", J, J)
        if rows.run is not None and eg not in block.groups:
            outer = index_sum(rows.run_first.shape[0], rows.run, outer)
            fl = fidx[rows.run_first]
        else:
            fl = fidx
        Hf = Hf + index_sum(Pr * Pr, (fl[:, :, None] * Pr + fl[:, None, :]).reshape(-1),
                            outer.reshape(-1))
        if eg in block.groups:
            ke = block.groups.index(eg)
            eidx = rows.indices[ke]
            JE = Js[ke] * free[eg][eidx].to(J.dtype)[:, None, :]
            Jf = torch.cat([Js[k] * free[block.groups[k]][rows.indices[k]].to(J.dtype)[:, None, :]
                            for k in rest], dim=-1)
            part = (eidx, JE, torch.einsum("mra,mrb->mab", Jf, JE), fidx)
    return cost, g_r, Hf.reshape(Pr, Pr), gE, part


def _track_pairs(eidx, T: int):
    """Rows sorted by point, and for every ordered pair of rows that share a
    point, the two positions in that order: (order, p, q)."""
    order = torch.argsort(eidx, stable=True)
    e = eidx[order]
    counts = torch.bincount(e, minlength=T)
    start = torch.cumsum(counts, 0) - counts
    n_per = counts[e]
    p = torch.repeat_interleave(torch.arange(e.shape[0], device=e.device), n_per)
    first = torch.cumsum(n_per, 0) - n_per
    q = start[e[p]] + torch.arange(p.shape[0], device=e.device) - first[p]
    return order, p, q


def solve_lm(groups: dict, blocks, fixed: dict | None = None,
             options: LMOptions = LMOptions(), schur: str | None = None):
    """Run LM. groups: {name: (N, W) float32}. fixed: {name: (N, W) bool}
    frozen coordinates (gauge fixing). schur: name of a group to eliminate
    per row (it must appear in exactly one block, once, beside other
    groups). Returns (groups, info) with info keys initial_cost,
    final_cost, iterations, lambda, nu, done."""
    dev = next(iter(groups.values())).device
    if fixed is None:
        fixed = {g: torch.zeros(v.shape, dtype=torch.bool, device=dev)
                 for g, v in groups.items()}
    free = {g: ~fixed[g] for g in groups}
    if schur is not None:
        refs = [b for b in blocks if schur in b.groups]
        if (len(refs) != 1 or refs[0].groups.count(schur) != 1
                or all(gr == schur for gr in refs[0].groups)
                or groups[schur].shape[1] != 3):
            raise ValueError(f"group {schur!r} is not eliminable (one block, once "
                             "per row, beside other groups, width 3)")
    rest = {k: v for k, v in groups.items() if k != schur}
    offs, P = _flat_layout(rest)
    if P > options.dense_max_params:
        raise NotImplementedError(
            f"{P} parameters exceed dense_max_params="
            f"{options.dense_max_params}: the PCG LM tier is not ported yet "
            "(ROADMAP.md)")
    keys = sorted(rest)
    fvec = torch.cat([free[k].reshape(-1) for k in keys]).to(torch.float32)
    eps = 1e-10

    def unflatten(v):
        return {k: v[offs[k]:offs[k] + groups[k].numel()].reshape(groups[k].shape)
                for k in keys}

    all_rows = [_valid_rows(b) for b in blocks]
    x = {k: v.clone() for k, v in groups.items()}
    lam = torch.tensor(options.init_lambda, dtype=torch.float32, device=dev)
    nu = torch.tensor(2.0, dtype=torch.float32, device=dev)
    done = torch.tensor(False, device=dev)
    init_cost = _total_cost(x, all_rows)
    if schur is not None:
        fE = free[schur].to(torch.float32)
        T = groups[schur].shape[0]
    it = 0
    while it < options.max_iters:
        if schur is None:
            cost, g, H = _linearize(x, all_rows, offs, P)
        else:
            cost, g, H, gE, part = _schur_linearize(x, all_rows, offs, P, schur, free)
            gE = gE * fE
        g = g * fvec
        H = H * fvec[:, None] * fvec[None, :]
        D2 = torch.diagonal(H)
        A = H + torch.diag(lam * (D2 + eps) + (1.0 - fvec))
        rhs = -g
        if schur is not None:
            eidx, JE, U, fidx = part
            V = index_sum(T, eidx, torch.einsum("mra,mrb->mab", JE, JE))
            dV = torch.diagonal(V, dim1=-2, dim2=-1)
            Vinv = _inv3(V + torch.diag_embed(lam * (dV + eps) + (1.0 - fE)))
            Y = U @ Vinv[eidx]                                      # (m, Wr, WE)
            order, pp, qq = _track_pairs(eidx, T)
            Ys, Us, fs = Y[order], U[order], fidx[order]
            Sf = torch.zeros(P * P, dtype=torch.float32, device=dev)
            for c0 in range(0, pp.shape[0], _SCHUR_PAIR_CHUNK):
                p_, q_ = pp[c0:c0 + _SCHUR_PAIR_CHUNK], qq[c0:c0 + _SCHUR_PAIR_CHUNK]
                blk = Ys[p_] @ Us[q_].transpose(-1, -2)
                Sf = Sf + index_sum(
                    P * P, (fs[p_][:, :, None] * P + fs[q_][:, None, :]).reshape(-1),
                    blk.reshape(-1))
            A = A - Sf.reshape(P, P)
            rhs = rhs + index_sum(P, fidx.reshape(-1),
                                  torch.einsum("mab,mb->ma", Y, gE[eidx]).reshape(-1))
        Lc, fail = torch.linalg.cholesky_ex(A)
        dflat = torch.cholesky_solve(rhs[:, None], Lc)[:, 0] * fvec
        delta = unflatten(dflat)
        pred = 0.5 * torch.dot(dflat, lam * (D2 + eps) * dflat - g)
        if schur is not None:
            acc = -gE - index_sum(T, eidx, torch.einsum("mab,ma->mb", U, dflat[fidx]))
            dp = (Vinv @ acc[..., None])[..., 0] * fE
            delta[schur] = dp
            pred = pred + 0.5 * torch.sum(dp * (lam * (dV + eps) * dp - gE))
        x_new = {k: x[k] + delta[k] for k in x}
        cost_new = _total_cost(x_new, all_rows)
        gain = (cost - cost_new) / torch.clamp_min(pred, 1e-30)
        accept = (cost_new < cost) & (pred > 0) & (fail == 0)
        x = {k: torch.where(accept, x_new[k], x[k]) for k in x}
        lam_acc = lam * torch.clamp_min(1.0 - (2.0 * gain - 1.0) ** 3, 1.0 / 3.0)
        lam = torch.clamp(torch.where(accept, lam_acc, lam * nu),
                          options.min_lambda, options.max_lambda)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        rel_drop = (cost - cost_new) / torch.clamp_min(cost, 1e-30)
        done = accept & (rel_drop < options.ftol)
        it += 1
        if bool(done):
            break
    info = {"initial_cost": init_cost, "final_cost": _total_cost(x, all_rows),
            "iterations": it, "lambda": lam, "nu": nu, "done": done}
    return x, info
