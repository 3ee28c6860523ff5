"""The PCG tier of the port's LM solver (panovlm_tpu_torch/solver/lm.py)
against the JAX package's (panovlm_tpu.solver.solve_lm), on the CPU.

Both tiers are forced: JAX with LMOptions(dense_max_params=0,
obs_chunk=None, jac_chunk=None), which also keeps it off the deleted
`_chunk_arrays` (ROADMAP F1), the port with dense_max_params=0, on the same
numpy inputs: (i) the run-length odometry block of
__graft_entry__._synthetic_problem (point-to-plane angle, Huber 2 deg,
scan 0 fixed, runs padded with masked garbage rows), (ii) a translation
averaging problem (groups t and s, soft L1, t_0 fixed), (iii) a small BA
problem given schur="pts" with dense_max_params below the reduced size, so
that both drop the elimination and run PCG over poses and points.
Tolerances are those of the dense tier's test: parameters within 1e-4,
costs within rtol 1e-3 (atol 1e-9). `_pcg` alone is held to JAX's `_pcg`
on a seeded SPD system (1e-5 relative), the tier selection to JAX's rules
case by case, the PCG tier to the port's dense tier at convergence (1e-4),
and fixed coordinates to their exact input bits.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _synthetic_problem
from panovlm_tpu.solver import LMOptions as JOptions
from panovlm_tpu.solver import ResidualBlock as JBlock
from panovlm_tpu.solver import lm as jlm
from panovlm_tpu.solver import make_schur_spec
from panovlm_tpu.solver import residuals as jres
from panovlm_tpu.solver import solve_lm as jsolve
from panovlm_tpu_torch.solver import lm as tlm
from panovlm_tpu_torch.solver import residuals as tres

torch.set_num_threads(2)

J_PCG = JOptions(dense_max_params=0, obs_chunk=None, jac_chunk=None)
RUN = 160


def _odometry_problem():
    """_synthetic_problem's pairs sorted into (r, n) runs, each padded to
    RUN rows with masked NaN rows (the stage's pair x point layout)."""
    poses0, fixed, pair_r, pair_n, pts_n, pl_r = _synthetic_problem(n_scans=6, n_obs=600)
    cols = [[], [], [], [], []]
    for r, n in np.unique(np.stack([pair_r, pair_n], 1), axis=0):
        sel = (pair_r == r) & (pair_n == n)
        k = int(sel.sum())
        assert k <= RUN
        cols[0].append(np.full(RUN, r, np.int32))
        cols[1].append(np.full(RUN, n, np.int32))
        cols[2].append(np.concatenate([pts_n[sel], np.full((RUN - k, 3), np.nan, np.float32)]))
        cols[3].append(np.concatenate([pl_r[sel], np.zeros((RUN - k, 4), np.float32)]))
        cols[4].append(np.arange(RUN) < k)
    pr, pn, pts, pl, mask = (np.concatenate(c) for c in cols)
    blocks = [dict(fn="point2plane_angle", groups=("poses", "poses"), indices=(pr, pn),
                   data=(pts, pl), weight=np.ones(len(pr), np.float32), mask=mask,
                   loss="huber", loss_scale=float(np.radians(2.0)), run_length=RUN)]
    return {"poses": poses0}, blocks, {"poses": fixed}


def _ta_problem(n=10, seed=3):
    """Pairwise translations of n camera centres on a loop, each frame to
    its next three, 1 deg of noise on the directions, scales 10 % off."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    c = np.stack([np.cos(ang) * 3, np.sin(ang) * 2, 0.1 * np.sin(3 * ang)], 1)
    pi = np.concatenate([np.arange(n)] * 3)
    pj = np.concatenate([(np.arange(n) + d) % n for d in (1, 2, 3)])
    m = len(pi)
    rel_aa = (rng.normal(size=(m, 3)) * 0.01).astype(np.float32)
    u = c[pj] - c[pi]       # rotations are identities: R_21 t_1 ~ t_1
    dist = np.linalg.norm(u, axis=1)
    u = u / dist[:, None] + rng.normal(size=(m, 3)) * np.radians(1.0)
    u = (u / np.linalg.norm(u, axis=1, keepdims=True)).astype(np.float32)
    t0 = (c + rng.normal(size=c.shape) * 0.3).astype(np.float32)
    t0[0] = c[0]
    s0 = (dist * rng.uniform(0.9, 1.1, m)).astype(np.float32)
    fixed_t = np.zeros((n, 3), bool)
    fixed_t[0] = True
    ar = np.arange(m)
    blocks = [dict(fn="pairwise_translation", groups=("t", "t", "s"), indices=(pi, pj, ar),
                   data=(rel_aa, u), weight=np.ones(m, np.float32), mask=np.ones(m, bool),
                   loss="soft_l1", loss_scale=0.1),
              dict(fn="scale_factor", groups=("s",), indices=(ar,),
                   data=(s0 * np.float32(0.9), s0 * np.float32(1.3)),
                   weight=np.ones(m, np.float32), mask=np.ones(m, bool))]
    return ({"t": t0, "s": s0[:, None]}, blocks,
            {"t": fixed_t, "s": np.zeros((m, 1), bool)})


def _ba_problem(n_cams=5, T=40, seed=5):
    """T points, each seen by every camera (the track-major layout JAX's
    SchurSpec needs), chordal rays with noise, Huber 4 deg; camera 0 and
    two points fixed, some observations masked."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (T, 3)) + [0, 0, 5]
    poses = np.zeros((n_cams, 6))
    poses[:, :3] = rng.normal(size=(n_cams, 3)) * 0.05
    poses[:, 3] = np.arange(n_cams) * 0.3
    obs_t = np.repeat(np.arange(T), n_cams)
    obs_img = np.tile(np.arange(n_cams), T)
    from scipy.spatial.transform import Rotation as ScR
    R = ScR.from_rotvec(poses[obs_img, :3]).as_matrix()
    pc = np.einsum("mij,mj->mi", R, X[obs_t]) + poses[obs_img, 3:]
    ray = pc / np.linalg.norm(pc, axis=1, keepdims=True) + rng.normal(size=pc.shape) * 1e-3
    ray = (ray / np.linalg.norm(ray, axis=1, keepdims=True)).astype(np.float32)
    mask = rng.uniform(size=len(obs_t)) > 0.15
    poses0 = (poses + rng.normal(size=poses.shape) * 0.01).astype(np.float32)
    poses0[0] = poses[0]
    X0 = (X + rng.normal(size=X.shape) * 0.05).astype(np.float32)
    fixed_p = np.zeros((n_cams, 6), bool)
    fixed_p[0] = True
    fixed_x = np.zeros((T, 3), bool)
    fixed_x[[3, 17]] = True
    blocks = [dict(fn="reproj_chordal", groups=("poses", "pts"), indices=(obs_img, obs_t),
                   data=(ray,), weight=np.ones(len(obs_t), np.float32), mask=mask,
                   loss="huber", loss_scale=float(np.radians(4.0)))]
    return {"poses": poses0, "pts": X0}, blocks, {"poses": fixed_p, "pts": fixed_x}


def _fn(mod, name):
    if name == "point2plane_angle":
        return functools.partial(mod.point2plane_angle, normalize_distance=True)
    return getattr(mod, name)


def _jax_solve(problem, options, schur=False):
    groups, blocks, fixed = problem
    jb = tuple(JBlock(_fn(jres, b["fn"]), b["groups"], tuple(jnp.asarray(i) for i in b["indices"]),
                      tuple(jnp.asarray(d) for d in b["data"]), jnp.asarray(b["weight"]),
                      jnp.asarray(b["mask"]), loss=b.get("loss", "trivial"),
                      loss_scale=b.get("loss_scale", 1.0), run_length=b.get("run_length", 1))
               for b in blocks)
    jg = {k: jnp.asarray(v) for k, v in groups.items()}
    spec = make_schur_spec(jg, jb, "pts") if schur else None
    assert (spec is not None) == schur
    out, info = jsolve(jg, jb, {k: jnp.asarray(v) for k, v in fixed.items()},
                       options, schur=spec)
    return {k: np.asarray(v) for k, v in out.items()}, info


def _torch_solve(problem, options, schur=False):
    groups, blocks, fixed = problem
    tb = tuple(tlm.ResidualBlock(
        _fn(tres, b["fn"]), b["groups"], tuple(torch.from_numpy(np.asarray(i)) for i in b["indices"]),
        tuple(torch.from_numpy(d) for d in b["data"]), torch.from_numpy(b["weight"]),
        torch.from_numpy(b["mask"]), loss=b.get("loss", "trivial"),
        loss_scale=b.get("loss_scale", 1.0), run_length=b.get("run_length", 1))
        for b in blocks)
    out, info = tlm.solve_lm({k: torch.from_numpy(v) for k, v in groups.items()}, tb,
                             {k: torch.from_numpy(v) for k, v in fixed.items()}, options,
                             schur="pts" if schur else None)
    return {k: v.numpy() for k, v in out.items()}, info


PROBLEMS = {
    "odometry_runs": (_odometry_problem, 5, 0, False),
    "translation_averaging": (_ta_problem, 8, 0, False),
    "ba_schur_dropped": (_ba_problem, 5, 12, True),
}


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_pcg_tier_matches_jax_pcg(name):
    make, iters, dmp, schur = PROBLEMS[name]
    problem = make()
    jout, jinfo = _jax_solve(problem, J_PCG._replace(max_iters=iters, dense_max_params=dmp),
                             schur)
    tout, tinfo = _torch_solve(problem, tlm.LMOptions(max_iters=iters, dense_max_params=dmp),
                               schur)
    assert tinfo["tier"] == "pcg"
    assert len(tinfo["cg_iterations"]) == tinfo["iterations"]
    for k in jout:
        np.testing.assert_allclose(tout[k], jout[k], atol=1e-4, err_msg=k)
    for key in ("initial_cost", "final_cost"):
        np.testing.assert_allclose(float(tinfo[key]), float(jinfo[key]), rtol=1e-3, atol=1e-9)
    assert float(tinfo["final_cost"]) < 0.5 * float(tinfo["initial_cost"])
    assert tinfo["iterations"] == int(jinfo["iterations"])


@pytest.mark.parametrize("iters", [7, 100])
def test_pcg_loop_matches_jax_pcg(iters):
    """`_pcg` on a seeded SPD system with a Jacobi preconditioner: the
    capped run (7, not a multiple of the host check) and the run that
    stops on the tolerance give JAX's iterate and the iteration count of a
    loop that tests before every iteration."""
    rng = np.random.default_rng(11)
    A = rng.normal(size=(60, 60))
    H = (A @ A.T + np.diag(rng.uniform(0.1, 5, 60))).astype(np.float32)
    b = rng.normal(size=60).astype(np.float32)
    dinv = (1.0 / np.diag(H)).astype(np.float32)
    xj = np.asarray(jlm._pcg(lambda v: jnp.asarray(H) @ v, jnp.asarray(b),
                             lambda r: jnp.asarray(dinv) * r, iters, 1e-6))
    Ht, dt = torch.from_numpy(H), torch.from_numpy(dinv)
    xt, k = tlm._pcg(lambda v: Ht @ v, torch.from_numpy(b), lambda r: dt * r, iters, 1e-6)
    np.testing.assert_allclose(xt.numpy(), xj, rtol=1e-5, atol=1e-5 * np.abs(xj).max())
    # the count of a loop that reads the test before every iteration
    x, r, p = torch.zeros(60), torch.from_numpy(b), dt * torch.from_numpy(b)
    rz, ref = torch.dot(r, p), 0
    bn = float(torch.sqrt(torch.dot(r, r))) + 1e-30
    while ref < iters and float(torch.sqrt(torch.dot(r, r))) > 1e-6 * bn:
        Hp = Ht @ p
        alpha = rz / (torch.dot(p, Hp) + 1e-30)
        r = r - alpha * Hp
        z = dt * r
        rz, rz_old = torch.dot(r, z), rz
        p = z + rz / (rz_old + 1e-30) * p
        ref += 1
    assert k == ref and (k == 7 if iters == 7 else 7 < k < 100)


TIERS = {   # dense_max_params, schur, expected tier (lm.py:698-709)
    "dense": (10_000, False, "dense"),
    "schur": (40, True, "schur"),
    "schur_dropped": (12, True, "pcg"),
    "zero_disables": (0, True, "pcg"),
}


@pytest.mark.parametrize("case", sorted(TIERS))
def test_tier_selection_follows_jax_rules(case):
    """BA problem: P = 5 x 6 + 40 x 3 = 150, Pr = 30 after eliminating the
    points. Dense when P <= dense_max_params without a Schur group; Schur
    when Pr <= dense_max_params; the elimination dropped above it; 0
    disables both. Each tier reaches JAX's result with the same options."""
    dmp, schur, tier = TIERS[case]
    problem = _ba_problem()
    tout, tinfo = _torch_solve(problem, tlm.LMOptions(max_iters=3, dense_max_params=dmp), schur)
    assert tinfo["tier"] == tier
    assert (len(tinfo["cg_iterations"]) > 0) == (tier == "pcg")
    jout, jinfo = _jax_solve(problem, J_PCG._replace(max_iters=3, dense_max_params=dmp), schur)
    for k in jout:
        np.testing.assert_allclose(tout[k], jout[k], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(tinfo["final_cost"]), float(jinfo["final_cost"]),
                               rtol=1e-3, atol=1e-9)


def test_pcg_tier_matches_dense_tier_at_convergence():
    problem = _odometry_problem()
    dout, dinfo = _torch_solve(problem, tlm.LMOptions(max_iters=20))
    pout, pinfo = _torch_solve(problem, tlm.LMOptions(max_iters=20, dense_max_params=0))
    assert (dinfo["tier"], pinfo["tier"]) == ("dense", "pcg")
    np.testing.assert_allclose(pout["poses"], dout["poses"], atol=1e-4)
    np.testing.assert_allclose(float(pinfo["final_cost"]), float(dinfo["final_cost"]),
                               rtol=1e-3, atol=1e-9)


def test_pcg_tier_keeps_fixed_coordinates_exactly():
    """Camera 0, points 3 and 17, and the rotation of camera 2 are fixed:
    their bits do not change, while every free coordinate moves."""
    groups, blocks, fixed = _ba_problem()
    fixed["poses"][2, :3] = True
    out, info = _torch_solve((groups, blocks, fixed), tlm.LMOptions(max_iters=5,
                                                                    dense_max_params=0))
    assert info["tier"] == "pcg"
    for k in groups:
        assert np.array_equal(out[k][fixed[k]], groups[k][fixed[k]]), k
        assert np.all(out[k][~fixed[k]] != groups[k][~fixed[k]]), k
