"""Levenberg-Marquardt — ported from `panovlm_tpu/solver/lm.py`.

Same algorithm as the JAX `solve_lm` (`lm.py:686-851`): residual families
are ResidualBlocks (one per-observation function mapped over the
observation axis, with validity masks); robust losses enter as IRLS weights
sqrt(rho'(s)) frozen per iteration; each step solves the whitened normal
equations (J^T J + lam D^2) delta = -g with D^2 = diag(J^T J); lambda
follows Nielsen's rule; gauge-fixed coordinates are projected out. Three
tiers, picked by JAX's rules (`lm.py:698-709`):

- dense, P <= `dense_max_params` parameters: H = J^T J assembled as a
  (P, P) matrix (run-length sums before the scatter), damped by
  lam * (diag(H) + eps) and solved by Cholesky.
- Schur (`lm.py:404-647`, `solve_lm(schur=...)`): a group that one block
  references once per observation (the BA points) is eliminated per point,
  and the reduced system over the other groups, Pr <= `dense_max_params`
  parameters, is solved densely. The JAX module lays the points out as
  padded (T, L) tracks and buckets short and long ones
  (`bucket_schur_points`); here the valid rows are ragged, and the reduced
  matrix sum_t U_t V_t^-1 U_t^T is scattered from the pairs of rows that
  share a point, in chunks of `_SCHUR_PAIR_CHUNK` pairs. When Pr exceeds
  `dense_max_params`, the elimination is dropped and PCG solves over every
  group, the points included.
- PCG (`_precond_blocks` :260, `_pcg` :655, the branch :780-818) for every
  other problem, and for all when `dense_max_params` is 0: preconditioned
  conjugate gradients on Hv(v) = P(J^T J P v) + lam (D^2 + eps) v, P the
  projection onto the free coordinates, with a block-Jacobi
  preconditioner (one W x W block of J^T J per parameter row, damped, 1 on
  the diagonal of fixed coordinates). JAX applies J^T J matrix-free, a jvp
  and a vjp through the residual functions in every CG iteration. Here the
  problem is linearised once per LM iteration and J^T J kept block-sparse:
  the W_t x W_t outer products of each row's Jacobian (W_t the width of
  the row's parameters together), summed per run, beside the row's flat
  parameter ids. A CG iteration is one gather, one batched small product
  and one exact scatter; (P, P) is never allocated.

PyTorch idiom: the LM loop is a Python loop whose exit test reads one flag
per iteration; the CG loop reads its exit test every `_CG_CHECK`
iterations, and the iterations after the stop leave its state as it was,
so it returns the iterate of a test before each iteration. Jacobians come
from `torch.func.vmap(jacrev)` over the valid observation rows only
(masked rows contribute exactly zero, so they are dropped up front instead
of being evaluated and zeroed). The JAX package's observation chunking
(`obs_chunk`/`jac_chunk`) exists for TPU lane padding and is not carried
over. `info["tier"]` names the tier that ran; `info["cg_iterations"]`
lists the CG iterations of each LM iteration of the PCG tier.

Every scattered sum (gradients, Hessian blocks, the Schur complement, the
preconditioner blocks and each CG iteration's J^T J v) goes through
`ops/exact.index_sum`: float `index_add_` on the card adds with atomics in
a varying order, and the solve amplifies its last-bit differences into
different poses from run to run (ROADMAP F9).

A block may be cut into chunks of `ResidualBlock.chunk` rows: every
per-row quantity (the residuals and their robust costs, the Jacobians,
the products J^T r, J^T J and, in PCG, J^T J v) is then computed one chunk
at a time, over that chunk's valid rows. A batched product or a short
reduction on the card, and a vectorised loop on the CPU, can give a row
other last bits at another place in a batch of another size; within a
chunk a row has one place, so its bits depend on its chunk alone, not on
the rows around the chunk. Only the exact sums join the chunks.

With a process group (`solve_lm(..., group=)`, `parallel.sharding.
DataGroup`) each rank holds whole chunks of every block's observation rows
(`parallel.shard_blocks`, or the odometry's pair chunks) and the
parameters whole. Every sum over rows (the gradient, J^T J or its blocks,
each CG iteration's J^T J v, the preconditioner, the costs) is an exact sum
over the group, so every rank gets the same bits whatever the split, one
rank included. The vectors of parameter size and every decision taken on
them (LM accept or reject, the early stop, the CG exit test, a failed
Cholesky) are then the same on every rank, and no rank decides alone.
Without a group the costs are float sums unless `LMOptions.exact_costs`
asks for the group's (the joint stage's LM path on the Room chain turns on
their last bits, so it keeps float costs). The tier under a group follows
the JAX package's sharded solves: no Schur elimination, dense or PCG by
the parameter count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch
from torch.func import jacrev, vmap

from ..ops.exact import group_sum, index_sum
from . import robust

_SCHUR_PAIR_CHUNK = 1 << 21   # row pairs per scatter into the reduced matrix
_CG_CHECK = 10                # CG iterations between two host reads of the exit test
_EPS = 1e-10                  # added to D^2 in the damping


@dataclass
class ResidualBlock:
    """One residual family: fn(*params, *data) -> (r_dim,) for one
    observation. params are the rows of the groups in `groups` picked by
    `indices` (one (M,) index tensor per group argument); data are (M, ...)
    per-observation constants. `run_length` > 1 promises that every index
    tensor is constant over consecutive runs of that length (the pair x
    point layout of the LiDAR blocks), so Hessian blocks are summed per run
    before they are scattered. `chunk` > 0 cuts the rows into chunks of
    that many (a multiple of `run_length` where the block has runs), each
    evaluated on its own; 0: one chunk."""
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
    chunk: int = 0


class LMOptions(NamedTuple):
    max_iters: int = 20          # reference SetOptionsLidar: 20
    cg_iters: int = 100          # reference max_linear_solver_iterations: 100
    cg_tol: float = 1e-6
    ftol: float = 1e-9
    init_lambda: float = 1e-4
    max_lambda: float = 1e10
    min_lambda: float = 1e-12
    # the dense tier up to this many parameters (the Schur tier: this many
    # after the elimination), PCG above; 0 disables both
    dense_max_params: int = 6144
    # sum the costs exactly (`ops/exact.group_sum`), as under a group
    exact_costs: bool = False


def _flat_layout(groups: dict):
    """Deterministic flattening of {g: (N, W)} into one P-vector."""
    offs, P = {}, 0
    for g in sorted(groups):
        N, W = groups[g].shape
        offs[g] = P
        P += N * W
    return offs, P


class _Rows(NamedTuple):
    """The valid observation rows of one chunk of a block (masked rows
    contribute exactly zero, so they are never evaluated)."""
    block: ResidualBlock
    indices: tuple        # per group argument, (m,) int64 parameter rows
    data: tuple           # (m, ...) per-observation constants
    weight: torch.Tensor  # (m,)
    run: torch.Tensor | None    # (m,) run of each row within the chunk, None without runs
    run_first: torch.Tensor | None  # (R,) first row of each run


class _Outer(NamedTuple):
    """One block's share of J^T J: per row (or run) the flat parameter ids
    (n, W_t) and the outer product of its Jacobian (n, W_t, W_t); per group
    argument (group, its parameter rows (n,), its first column in W_t, its
    width), which locate the block-diagonal parts; the rows (runs) of each
    chunk, in order."""
    fidx: torch.Tensor
    outer: torch.Tensor
    args: tuple
    splits: list


def _has_runs(block: ResidualBlock) -> bool:
    return block.run_length > 1 and block.mask.shape[0] % block.run_length == 0


def _valid_rows(block: ResidualBlock, whole: bool = False):
    """(block, [_Rows of each chunk that has valid rows]); whole=True takes
    the block as one chunk."""
    n = block.mask.shape[0]
    rl = block.run_length
    step = n if whole or block.chunk <= 0 else block.chunk
    if _has_runs(block) and step % rl and step < n:
        raise ValueError(f"block {block.name!r}: chunk {step} cuts its runs of {rl}")
    chunks = []
    for c0 in range(0, n, max(step, 1)):
        rows = torch.nonzero(block.mask[c0:c0 + step], as_tuple=True)[0]
        if rows.numel() == 0:
            continue
        if c0:
            rows = rows + c0
        run = run_first = None
        if _has_runs(block):
            _, run, counts = torch.unique_consecutive(
                torch.div(rows, rl, rounding_mode="floor"),
                return_inverse=True, return_counts=True)
            run_first = torch.cumsum(counts, 0) - counts
        chunks.append(_Rows(block, tuple(i[rows].long() for i in block.indices),
                            tuple(d[rows] for d in block.data), block.weight[rows],
                            run, run_first))
    return block, chunks


def _params(rows: _Rows, x: dict):
    return [x[g][i] for g, i in zip(rows.block.groups, rows.indices)]


def _finite(r):
    """Non-finite -> 0 (Ceres drops residual blocks it cannot evaluate)."""
    return torch.where(torch.isfinite(r), r, torch.zeros_like(r))


def _rho(block: ResidualBlock, r):
    """Squared norms s (m,) of the rows of r and their robust costs."""
    s = torch.sum(r * r, dim=-1)
    return s, robust.rho(block.loss, s, block.loss_scale)


def _cost(rhos: list, dev, group=None, exact: bool = False):
    """0.5 * the sum of the chunks' robust costs: a float sum, or exact over
    the group's ranks (every rank must call, with its chunks, maybe none)."""
    rho = (rhos[0] if len(rhos) == 1 else
           torch.cat(rhos) if rhos else torch.zeros(0, dtype=torch.float32, device=dev))
    return 0.5 * (group_sum(rho, group) if exact or group is not None else torch.sum(rho))


def _cat(parts: list, empty):
    return parts[0] if len(parts) == 1 else torch.cat(parts) if parts else empty


def _total_cost(x: dict, all_rows, group=None, exact: bool = False) -> torch.Tensor:
    dev = next(iter(x.values())).device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for block, chunks in all_rows:
        if not chunks and group is None:
            continue
        rhos = [_rho(block, _finite(vmap(block.fn)(*_params(rows, x), *rows.data)
                                    * rows.weight[:, None]))[1] for rows in chunks]
        total = total + _cost(rhos, dev, group, exact)
    return total


def _linearize_chunk(rows: _Rows, x: dict, offs: dict):
    """One chunk's robust costs, flat parameter ids (m, W_t), gradient terms
    J^T r (m, W_t) and outer products J^T J (m, W_t, W_t) of its
    IRLS-whitened rows."""
    block = rows.block

    def fn_aux(*args):
        r = block.fn(*args)
        return r, r

    Js, r = vmap(jacrev(fn_aux, argnums=tuple(range(len(block.groups))),
                        has_aux=True))(*_params(rows, x), *rows.data)
    r = _finite(r * rows.weight[:, None])
    s, rho = _rho(block, r)
    w = torch.sqrt(robust.rho_prime(block.loss, s, block.loss_scale))
    scale = (rows.weight * w)[:, None, None]
    J = torch.cat([_finite(Jk) * scale for Jk in Js], dim=-1)   # (m, r_dim, sum W)
    fidx = torch.cat([offs[gr] + i[:, None] * Jk.shape[-1]
                      + torch.arange(Jk.shape[-1], device=J.device)
                      for gr, i, Jk in zip(block.groups, rows.indices, Js)], dim=-1)
    return (rho, fidx, torch.einsum("mri,mr->mi", J, r * w[:, None]),
            torch.einsum("mri,mrj->mij", J, J))


def _linearize_blocks(x: dict, all_rows, offs: dict, P: int, group=None,
                      exact: bool = False):
    """Cost, gradient g = J^T F and the block-sparse J^T J (one _Outer per
    block) of the IRLS-whitened residual vector F at x."""
    dev = next(iter(x.values())).device
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    g = torch.zeros(P, dtype=torch.float32, device=dev)
    parts = []
    for block, chunks in all_rows:
        if not chunks and group is None:
            continue
        Ws = [x[gr].shape[1] for gr in block.groups]
        Wt = sum(Ws)
        lin = [_linearize_chunk(rows, x, offs) for rows in chunks]
        f = dict(dtype=torch.float32, device=dev)
        cost = cost + _cost([c[0] for c in lin], dev, group, exact)
        fidx = _cat([c[1] for c in lin], torch.zeros((0, Wt), dtype=torch.int64, device=dev))
        g = g + index_sum(P, fidx.reshape(-1),
                          _cat([c[2] for c in lin], torch.zeros((0, Wt), **f)).reshape(-1),
                          group)
        outer = _cat([c[3] for c in lin], torch.zeros((0, Wt, Wt), **f))
        idx = tuple(_cat([rows.indices[k] for rows in chunks],
                         torch.zeros(0, dtype=torch.int64, device=dev))
                    for k in range(len(Ws)))
        splits = [rows.weight.shape[0] for rows in chunks]
        if _has_runs(block):   # sum each run (whole on one rank) before the scatter
            n_runs = [rows.run_first.shape[0] for rows in chunks]
            r0 = [sum(n_runs[:k]) for k in range(len(chunks))]
            m0 = [sum(splits[:k]) for k in range(len(chunks))]
            run = _cat([rows.run + o for rows, o in zip(chunks, r0)],
                       torch.zeros(0, dtype=torch.int64, device=dev))
            first = _cat([rows.run_first + o for rows, o in zip(chunks, m0)],
                         torch.zeros(0, dtype=torch.int64, device=dev))
            outer = index_sum(sum(n_runs), run, outer, group, scale_only=True)
            fidx = fidx[first]
            idx = tuple(i[first] for i in idx)
            splits = n_runs
        c0 = [sum(Ws[:k]) for k in range(len(Ws))]
        parts.append(_Outer(fidx, outer, tuple(zip(block.groups, idx, c0, Ws)), splits))
    return cost, g, parts


def _linearize(x: dict, all_rows, offs: dict, P: int, group=None, exact: bool = False):
    """Cost, gradient g = J^T F and dense H = J^T J (P, P) of the
    IRLS-whitened residual vector F at x."""
    cost, g, parts = _linearize_blocks(x, all_rows, offs, P, group, exact)
    Hf = torch.zeros(P * P, dtype=torch.float32, device=g.device)
    for p in parts:
        flat = p.fidx[:, :, None] * P + p.fidx[:, None, :]
        Hf = Hf + index_sum(P * P, flat.reshape(-1), p.outer.reshape(-1), group)
    return cost, g, Hf.reshape(P, P)


def _precond_blocks(x: dict, parts, free: dict, group=None):
    """Block-diagonal J^T J: one (W, W) block per parameter row of each
    group (JAX `_precond_blocks`: each group argument's own block, so a row
    that one observation references twice gets no cross term), fixed
    coordinates zeroed."""
    out = {}
    for g, v in x.items():
        idx = [i for p in parts for gr, i, _, _ in p.args if gr == g]
        blk = [p.outer[:, c:c + W, c:c + W]
               for p in parts for gr, _, c, W in p.args if gr == g]
        if idx:
            B = index_sum(v.shape[0], torch.cat(idx), torch.cat(blk), group)
        else:
            B = torch.zeros(v.shape + v.shape[-1:], dtype=v.dtype, device=v.device)
        f = free[g].to(B.dtype)
        out[g] = B * f[:, :, None] * f[:, None, :]
    return out


def _pcg(Hv, b, Minv, iters: int, tol: float):
    """Preconditioned conjugate gradients for H x = b from x = 0 (JAX
    `_pcg`): stops at the first k with k == iters or |r| <= tol (|b| +
    1e-30). The test is evaluated on the device before each iteration and
    read by the host every _CG_CHECK iterations; an iteration after the
    stop keeps the state as it was. Returns (x, k)."""
    x = torch.zeros_like(b)
    r = b
    p = Minv(r)
    rz = torch.dot(r, p)
    thresh = tol * (torch.sqrt(torch.dot(b, b)) + 1e-30)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    done = 0
    while done < iters:
        for _ in range(min(_CG_CHECK, iters - done)):
            active = torch.sqrt(torch.dot(r, r)) > thresh
            Hp = Hv(p)
            alpha = rz / (torch.dot(p, Hp) + 1e-30)
            r_new = r - alpha * Hp
            z = Minv(r_new)
            rz_new = torch.dot(r_new, z)
            beta = rz_new / (rz + 1e-30)
            x = torch.where(active, x + alpha * p, x)
            p = torch.where(active, z + beta * p, p)
            r = torch.where(active, r_new, r)
            rz = torch.where(active, rz_new, rz)
            k = k + active
            done += 1
        if not bool(torch.sqrt(torch.dot(r, r)) > thresh):
            break
    return x, int(k)


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


def _schur_linearize(x: dict, all_rows, offs_r: dict, Pr: int, eg: str, free: dict,
                     exact: bool = False):
    """Cost, the rest groups' gradient (Pr,) and dense H (Pr, Pr), the
    eliminated group's gradient (T, WE), and for its block: per valid row
    the point index, J_E (m, r, WE), U = J_rest^T J_E (m, Wr, WE) and the
    flat rest-parameter ids (m, Wr). Fixed coordinates of the rest groups
    are zeroed in U, those of the points in J_E (as `_schur_pass` does).
    all_rows holds each block whole (one chunk)."""
    dev = next(iter(x.values())).device
    cost = torch.zeros((), dtype=torch.float32, device=dev)
    g_r = torch.zeros(Pr, dtype=torch.float32, device=dev)
    Hf = torch.zeros(Pr * Pr, dtype=torch.float32, device=dev)
    gE = torch.zeros_like(x[eg])
    part = None
    for block, chunks in all_rows:
        if not chunks:
            continue
        rows, = chunks

        def fn_aux(*args):
            r = block.fn(*args)
            return r, r

        Js, r = vmap(jacrev(fn_aux, argnums=tuple(range(len(block.groups))),
                            has_aux=True))(*_params(rows, x), *rows.data)
        r = _finite(r * rows.weight[:, None])
        s, rho = _rho(block, r)
        cost = cost + _cost([rho], dev, exact=exact)
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


def _tier(groups: dict, options: LMOptions, schur: str | None, group=None):
    """JAX's tier selection (`lm.py:698-709`): (tier, Schur group or None).
    Under a group no Schur elimination, as in the JAX package's sharded
    solves (`camera_lidar.py:327-340`)."""
    if schur is not None and group is None:
        _, Pr = _flat_layout({k: v for k, v in groups.items() if k != schur})
        if options.dense_max_params and Pr <= options.dense_max_params:
            return "schur", schur
    _, P = _flat_layout(groups)
    if options.dense_max_params and P <= options.dense_max_params:
        return "dense", None
    return "pcg", None


def solve_lm(groups: dict, blocks, fixed: dict | None = None,
             options: LMOptions = LMOptions(), schur: str | None = None, group=None):
    """Run LM. groups: {name: (N, W) float32}. fixed: {name: (N, W) bool}
    frozen coordinates (gauge fixing). schur: name of a group to eliminate
    per row (it must appear in exactly one block, once per row, beside
    other groups); dropped, as in JAX, when the reduced system exceeds
    `options.dense_max_params`, and under a group. group: a
    `parallel.sharding.DataGroup`; blocks then hold this rank's rows
    (`parallel.shard_blocks`), groups and fixed the same on every rank.
    Returns (groups, info) with info keys initial_cost, final_cost,
    iterations, lambda, nu, done, tier ("dense", "schur" or "pcg") and
    cg_iterations (per LM iteration of the PCG tier), the same on every
    rank of a group."""
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
    tier, schur = _tier(groups, options, schur, group)
    rest = {k: v for k, v in groups.items() if k != schur}
    offs, P = _flat_layout(rest)
    keys = sorted(rest)
    fvec = torch.cat([free[k].reshape(-1) for k in keys]).to(torch.float32)

    def unflatten(v):
        return {k: v[offs[k]:offs[k] + groups[k].numel()].reshape(groups[k].shape)
                for k in keys}

    exact = options.exact_costs or group is not None
    all_rows = [_valid_rows(b, whole=schur is not None) for b in blocks]
    x = {k: v.clone() for k, v in groups.items()}
    lam = torch.tensor(options.init_lambda, dtype=torch.float32, device=dev)
    nu = torch.tensor(2.0, dtype=torch.float32, device=dev)
    done = torch.tensor(False, device=dev)
    init_cost = _total_cost(x, all_rows, group, exact)
    if schur is not None:
        fE = free[schur].to(torch.float32)
        T = groups[schur].shape[0]
    cg_counts = []
    it = 0
    while it < options.max_iters:
        fail = 0
        if tier == "pcg":
            cost, g, parts = _linearize_blocks(x, all_rows, offs, P, group, exact)
            g = g * fvec
            B = _precond_blocks(x, parts, free, group)
            D2 = torch.cat([torch.diagonal(B[k], dim1=-2, dim2=-1).reshape(-1)
                            for k in keys])
            damp = lam * (D2 + _EPS)
            fidx = torch.cat([p.fidx.reshape(-1) for p in parts])
            # block-Jacobi of (J^T J + lam D^2), 1 on the diagonal of fixed
            # coordinates; inverted once per LM iteration
            Binv = {k: torch.linalg.inv(B[k] + torch.diag_embed(d + fixed[k].to(d.dtype)))
                    for k, d in unflatten(damp).items()}

            def Hv(v):
                v = v * fvec
                hv = index_sum(P, fidx, _cat([   # chunk by chunk, as linearised
                    torch.einsum("nij,nj->ni", o, v[f]).reshape(-1) for p in parts
                    for o, f in zip(p.outer.split(p.splits), p.fidx.split(p.splits))],
                    v[:0]), group)
                return hv * fvec + damp * v

            def Minv(r):
                return torch.cat([(Binv[k] @ r_k[:, :, None])[:, :, 0].reshape(-1)
                                  for k, r_k in unflatten(r).items()]) * fvec

            dflat, k_cg = _pcg(Hv, -g, Minv, options.cg_iters, options.cg_tol)
            cg_counts.append(k_cg)
            dflat = dflat * fvec
            delta = unflatten(dflat)
            pred = 0.5 * torch.dot(dflat, damp * dflat - g)
        else:
            if schur is None:
                cost, g, H = _linearize(x, all_rows, offs, P, group, exact)
            else:
                cost, g, H, gE, part = _schur_linearize(x, all_rows, offs, P, schur, free,
                                                         exact)
                gE = gE * fE
            g = g * fvec
            H = H * fvec[:, None] * fvec[None, :]
            D2 = torch.diagonal(H)
            A = H + torch.diag(lam * (D2 + _EPS) + (1.0 - fvec))
            rhs = -g
            if schur is not None:
                eidx, JE, U, fidx = part
                V = index_sum(T, eidx, torch.einsum("mra,mrb->mab", JE, JE))
                dV = torch.diagonal(V, dim1=-2, dim2=-1)
                Vinv = _inv3(V + torch.diag_embed(lam * (dV + _EPS) + (1.0 - fE)))
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
            pred = 0.5 * torch.dot(dflat, lam * (D2 + _EPS) * dflat - g)
            if schur is not None:
                acc = -gE - index_sum(T, eidx, torch.einsum("mab,ma->mb", U, dflat[fidx]))
                dp = (Vinv @ acc[..., None])[..., 0] * fE
                delta[schur] = dp
                pred = pred + 0.5 * torch.sum(dp * (lam * (dV + _EPS) * dp - gE))
        x_new = {k: x[k] + delta[k] for k in x}
        cost_new = _total_cost(x_new, all_rows, group, exact)
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
    info = {"initial_cost": init_cost, "final_cost": _total_cost(x, all_rows, group, exact),
            "iterations": it, "lambda": lam, "nu": nu, "done": done,
            "tier": tier, "cg_iterations": cg_counts}
    return x, info
