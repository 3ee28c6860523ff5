"""Solver of the port (panovlm_tpu_torch/solver/) against the JAX package.

Residuals: the five odometry residual functions and their torch.func
Jacobians against the JAX functions and jax.jacfwd, on seeded random
observations; tolerance rtol 1e-4, atol 1e-5 (float32, transcendental
functions and sums rounded differently).

LM: the dense tier on __graft_entry__._synthetic_problem() (512 rows, below
every chunk size of the JAX solver) against panovlm_tpu.solver.solve_lm;
poses within 1e-4, costs within rtol 1e-3 (plus atol 1e-9: after 5
iterations both solves sit at the float32 round-off floor, ~1e-12).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacrev, vmap

from __graft_entry__ import _synthetic_problem
from panovlm_tpu.solver import LMOptions as JOptions
from panovlm_tpu.solver import ResidualBlock as JBlock
from panovlm_tpu.solver import residuals as jres
from panovlm_tpu.solver import solve_lm as jsolve
from panovlm_tpu_torch.solver import lm as tlm
from panovlm_tpu_torch.solver import residuals as tres

torch.set_num_threads(2)

M = 64


def _obs(rng):
    poses = np.concatenate([rng.normal(size=(2, M, 3)) * 0.2,
                            rng.normal(size=(2, M, 3)) * 0.5], -1).astype(np.float32)
    pts = (rng.normal(size=(M, 3)) * 2 + [0, 0, 3]).astype(np.float32)
    dirs = rng.normal(size=(2, M, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    plane = np.concatenate([dirs[0], rng.normal(size=(M, 1)).astype(np.float32)], -1)
    line_pt = (pts + rng.normal(size=(M, 3)) * 0.3).astype(np.float32)
    return poses[0], poses[1], pts, plane, line_pt, dirs[1], dirs[0]


CASES = {
    "point2plane_meter": lambda o: (o[0], o[1], o[2], o[3]),
    "point2plane_angle": lambda o: (o[0], o[1], o[2], o[3]),
    "point2line_meter": lambda o: (o[0], o[1], o[2], o[4], o[5]),
    "point2line_angle": lambda o: (o[0], o[1], o[2], o[4], o[5]),
    "line2line_angle": lambda o: (o[0], o[1], o[5], o[6]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_residual_and_jacobians_match_jax(name):
    args = CASES[name](_obs(np.random.default_rng(len(name))))
    jf, tf = getattr(jres, name), getattr(tres, name)
    jargs = [jnp.asarray(a) for a in args]
    targs = [torch.from_numpy(a) for a in args]
    r_ref = np.asarray(jax.vmap(jf)(*jargs))
    r = vmap(tf)(*targs).numpy()
    np.testing.assert_allclose(r, r_ref, rtol=1e-4, atol=1e-5)
    J_ref = jax.vmap(jax.jacfwd(jf, argnums=(0, 1)))(*jargs)
    J = vmap(jacrev(tf, argnums=(0, 1)))(*targs)
    for a, b in zip(J, J_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("iters", [1, 5])
def test_dense_lm_matches_jax_on_synthetic_problem(iters):
    poses0, fixed, pair_r, pair_n, pts_n, pl_r = _synthetic_problem()
    n = pts_n.shape[0]
    jblock = JBlock(jres.point2plane_meter, ("poses", "poses"),
                    (jnp.asarray(pair_r), jnp.asarray(pair_n)),
                    (jnp.asarray(pts_n), jnp.asarray(pl_r)),
                    jnp.ones((n,), jnp.float32), jnp.ones((n,), bool),
                    loss="huber", loss_scale=0.2)
    jout, jinfo = jsolve({"poses": jnp.asarray(poses0)}, (jblock,),
                         {"poses": jnp.asarray(fixed)}, JOptions(max_iters=iters))
    tblock = tlm.ResidualBlock(tres.point2plane_meter, ("poses", "poses"),
                               (torch.from_numpy(pair_r), torch.from_numpy(pair_n)),
                               (torch.from_numpy(pts_n), torch.from_numpy(pl_r)),
                               torch.ones(n), torch.ones(n, dtype=torch.bool),
                               loss="huber", loss_scale=0.2)
    tout, tinfo = tlm.solve_lm({"poses": torch.from_numpy(poses0)}, (tblock,),
                               {"poses": torch.from_numpy(fixed)},
                               tlm.LMOptions(max_iters=iters))
    np.testing.assert_allclose(tout["poses"].numpy(), np.asarray(jout["poses"]),
                               atol=1e-4)
    for key in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(tinfo[key]), float(jinfo[key]),
                                   rtol=1e-3, atol=1e-9)
    assert float(tinfo["final_cost"]) < 0.5 * float(tinfo["initial_cost"])
    assert tinfo["iterations"] == int(jinfo["iterations"])


def test_masked_rows_and_run_lengths_do_not_change_the_solve():
    """Masked observations contribute nothing, and the run-length Hessian
    sums equal the per-row scatter."""
    poses0, fixed, pair_r, pair_n, pts_n, pl_r = _synthetic_problem(n_obs=256)
    order = np.lexsort((pair_n, pair_r))
    pair_r, pair_n, pts_n, pl_r = (a[order] for a in (pair_r, pair_n, pts_n, pl_r))
    n = len(pair_r)
    fn = functools.partial(tres.point2plane_angle, normalize_distance=True)

    def solve(pr, pn, pts, pl, mask, rl):
        blk = tlm.ResidualBlock(fn, ("poses", "poses"),
                                (torch.from_numpy(pr), torch.from_numpy(pn)),
                                (torch.from_numpy(pts), torch.from_numpy(pl)),
                                torch.ones(len(pr)), torch.from_numpy(mask),
                                loss="huber", loss_scale=np.radians(2.0),
                                run_length=rl)
        return tlm.solve_lm({"poses": torch.from_numpy(poses0)}, (blk,),
                            {"poses": torch.from_numpy(fixed)},
                            tlm.LMOptions(max_iters=4))[0]["poses"]

    base = solve(pair_r, pair_n, pts_n, pl_r, np.ones(n, bool), 1)
    # pad each (r, n) run to 128 rows with masked garbage rows
    runs = np.unique(np.stack([pair_r, pair_n], 1), axis=0)
    cols = [[], [], [], [], []]
    for r, nn in runs:
        sel = (pair_r == r) & (pair_n == nn)
        k = int(sel.sum())
        cols[0].append(np.full(128, r, np.int32))
        cols[1].append(np.full(128, nn, np.int32))
        cols[2].append(np.concatenate([pts_n[sel], np.full((128 - k, 3), np.nan, np.float32)]))
        cols[3].append(np.concatenate([pl_r[sel], np.zeros((128 - k, 4), np.float32)]))
        cols[4].append(np.arange(128) < k)
    padded = solve(*[np.concatenate(c) for c in cols], 128)
    np.testing.assert_allclose(padded.numpy(), base.numpy(), atol=1e-5)

