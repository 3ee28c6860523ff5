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
lane padding and is not carried over. Problems above `dense_max_params`
parameters raise: the PCG and Schur tiers are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch.func import jacrev, vmap

from . import robust


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
        g.index_add_(0, fidx.reshape(-1),
                     torch.einsum("mri,mr->mi", J, r * w[:, None]).reshape(-1))
        outer = torch.einsum("mri,mrj->mij", J, J)      # (m, sum W, sum W)
        if rows.run is not None:   # sum each run before the scatter
            outer = torch.zeros((rows.run_first.shape[0],) + outer.shape[1:],
                                dtype=outer.dtype, device=dev).index_add_(
                0, rows.run, outer)
            fidx = fidx[rows.run_first]
        flat = fidx[:, :, None] * P + fidx[:, None, :]
        Hf.index_add_(0, flat.reshape(-1), outer.reshape(-1))
    return cost, g, Hf.reshape(P, P)


def solve_lm(groups: dict, blocks, fixed: dict | None = None,
             options: LMOptions = LMOptions()):
    """Run LM. groups: {name: (N, W) float32}. fixed: {name: (N, W) bool}
    frozen coordinates (gauge fixing). Returns (groups, info) with info
    keys initial_cost, final_cost, iterations, lambda, nu, done."""
    dev = next(iter(groups.values())).device
    if fixed is None:
        fixed = {g: torch.zeros(v.shape, dtype=torch.bool, device=dev)
                 for g, v in groups.items()}
    offs, P = _flat_layout(groups)
    free = {g: ~fixed[g] for g in groups}
    if P > options.dense_max_params:
        raise NotImplementedError(
            f"{P} parameters exceed dense_max_params="
            f"{options.dense_max_params}: the PCG and Schur LM tiers are not "
            "ported yet (ROADMAP.md)")
    keys = sorted(groups)
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
    it = 0
    while it < options.max_iters:
        cost, g, H = _linearize(x, all_rows, offs, P)
        g = g * fvec
        H = H * fvec[:, None] * fvec[None, :]
        D2 = torch.diagonal(H)
        A = H + torch.diag(lam * (D2 + eps) + (1.0 - fvec))
        Lc, fail = torch.linalg.cholesky_ex(A)
        dflat = torch.cholesky_solve(-g[:, None], Lc)[:, 0] * fvec
        delta = unflatten(dflat)
        x_new = {k: x[k] + delta[k] for k in keys}
        cost_new = _total_cost(x_new, all_rows)
        pred = 0.5 * torch.dot(dflat, lam * (D2 + eps) * dflat - g)
        gain = (cost - cost_new) / torch.clamp_min(pred, 1e-30)
        accept = (cost_new < cost) & (pred > 0) & (fail == 0)
        x = {k: torch.where(accept, x_new[k], x[k]) for k in keys}
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
