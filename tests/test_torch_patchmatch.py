"""The port's plane-sweep PatchMatch (ops/patchmatch.py, ops/volscore.py)
against panovlm_tpu/ops/patchmatch.py on the same seeded inputs.

  * The plain K3 (`volscore_reference`, what `volscore` runs on a CPU
    tensor) against the JAX XLA vol path of ncc_cost and against the Pallas
    kernel in interpret mode, at tests/test_mvs.py's shapes and inputs:
    atol 2e-4, the bound test_mvs holds the Pallas kernel to.
  * The sweep volumes against build_sweep_volume on PackedViews: the same
    u8/u16 taps and weights; the samples differ in the last float bits, so
    a few bf16 roundings flip (<= 1 bf16 step, on < 1% of the elements).
  * The initial multiview cost (K3 with one candidate, plus the geometric
    term with the neighbour-depth volumes): 99.9% of pixels within 2e-4
    photometric only, 99% within 1e-3 with the geometric term, every pixel
    within 0.05. Two amplifiers of last-bit differences: NCC on a nearly
    flat patch (variance near its eps clamp) and arccos of a cosine next to
    1 (one float step of the cosine is ~0.02 deg, 0.01 of the penalty).
  * One sequential and one checkerboard step, with the JAX package's
    jax.random draws injected into the port and the same volumes: the share
    of pixels whose picked plane differs stays below 2% (argmin between
    candidates whose costs differ at the level above, ROADMAP F5); the
    costs of the pixels that agree meet the same bounds as above.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panovlm_tpu.models import mvs as jmvs
from panovlm_tpu.ops import patchmatch as jpm
from panovlm_tpu.ops import spherical as jsp
from panovlm_tpu.ops.pallas import volscore as jvs
from panovlm_tpu_torch.models import mvs as tmvs
from panovlm_tpu_torch.ops import patchmatch as tpm
from panovlm_tpu_torch.ops import spherical as tsp
from panovlm_tpu_torch.ops import volscore as tvs

from synthetic import render_panorama

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _bf16(a):
    return torch.from_numpy(np.asarray(jnp.asarray(a).astype(jnp.float32))).to(torch.bfloat16)


def test_plain_volscore_matches_xla_and_pallas():
    Hs, Ws, V, D, C = 32, 128, 2, 8, 3
    rng = np.random.default_rng(3)
    cfg = jpm.PatchMatchConfig(ncc_half_window=4, ncc_step=2, min_depth=0.5,
                               max_depth=10.0, sweep_slices=D)
    rays = jsp.pixel_ray_grid(Hs, Ws)
    vols = jnp.asarray(rng.uniform(size=(V, D, Hs, Ws)).astype(np.float32)
                       ).astype(jnp.bfloat16)
    gray_ref = jnp.asarray(rng.uniform(size=(Hs, Ws)).astype(np.float32))
    depths = jnp.asarray(rng.uniform(1, 5, size=(C, Hs, Ws)).astype(np.float32))
    normals = jnp.stack([jpm.random_normals(jax.random.PRNGKey(i), rays)
                         for i in range(C)])
    offsets = tuple(jpm._patch_offsets(cfg))
    i_tab, w_tab = jpm.ref_tables(gray_ref, offsets, cfg)
    inv0 = 1.0 / cfg.max_depth
    inv_step = (1.0 / cfg.min_depth - inv0) / (D - 1)
    xla = np.asarray(jnp.stack([jnp.stack([jpm.ncc_cost(
        gray_ref, None, rays, depths[c], normals[c], jnp.eye(3), jnp.zeros(3),
        cfg, offsets=offsets, tabs=(i_tab, w_tab), vol=vols[v])
        for c in range(C)]) for v in range(V)]))
    rho = depths * jnp.sum(normals * rays[None], axis=-1)
    pallas = np.asarray(jvs.score_candidates(
        vols, rho, jnp.moveaxis(normals, -1, 1), jnp.moveaxis(rays, -1, 0),
        i_tab, w_tab, offsets, inv0, inv_step, cfg.min_depth, cfg.max_depth,
        h_tile=8, interpret=True))
    n0 = tvs.volscore.launches
    out = tvs.volscore(_bf16(vols), _t(depths), _t(jnp.moveaxis(normals, -1, 1)),
                       _t(jnp.moveaxis(rays, -1, 0)), _t(gray_ref), offsets,
                       inv0, inv_step, cfg.min_depth, cfg.max_depth).numpy()
    assert tvs.volscore.launches == n0      # CPU tensors: the plain version
    np.testing.assert_allclose(out, xla, atol=2e-4)
    np.testing.assert_allclose(out, pallas, atol=2e-4)


# ----------------------------------------------------------------------------
# a small scene: 4 panoramas of the synthetic room
# ----------------------------------------------------------------------------

H, W = 48, 96
CENTERS = ((0.0, 0.4, 0.0), (0.7, 0.4, 0.2), (-0.5, 0.2, -0.4), (0.2, 0.6, -0.7))


@pytest.fixture(scope="module")
def scene():
    grays, depths = zip(*[render_panorama(np.array(c), H, W) for c in CENTERS])
    poses = np.zeros((4, 6), np.float32)
    poses[:, 3:] = -np.asarray(CENTERS, np.float32)     # R = I -> t_cw = -C
    cfg = jpm.PatchMatchConfig(ncc_half_window=3, ncc_step=1, min_depth=0.4,
                               max_depth=8.0, sweep_slices=16)
    return dict(grays=np.stack(grays), depths=np.stack(depths), poses=poses, cfg=cfg)


def _jax_volumes(scene, with_depth):
    cfg = scene["cfg"]
    nei = np.array([1, 2, 3])
    rays = jsp.pixel_ray_grid(H, W)
    R, t = jmvs.relative_to_neighbors(scene["poses"], 0, nei)
    views = jpm.pack_views(jnp.asarray(scene["grays"][nei]))
    nd = None
    if with_depth:
        nd = jax.vmap(lambda d: jsp.pack_bilinear_u16(d)[0])(
            jnp.asarray(scene["depths"][nei] * 1.02))
    out = jpm.build_sweep_volume(views, rays, R, t, cfg, nd)
    return (views, nd, R, t) + (out if with_depth else (out, None))


def _port_setup(scene):
    cfg = tpm.PatchMatchConfig(**{k: v for k, v in scene["cfg"]._asdict().items()
                                  if k in tpm.PatchMatchConfig._fields})
    R, t = tmvs.relative_to_neighbors(scene["poses"], 0, np.array([1, 2, 3]))
    return cfg, tsp.pixel_ray_grid(H, W), R, t


def _port_volumes(scene, with_depth):
    cfg, rays, R, t = _port_setup(scene)
    nei = np.array([1, 2, 3])
    qs = [tsp.quantize_u8(_t(g)) for g in scene["grays"][nei]]
    nd = tsp.quantize_u16(_t(scene["depths"][nei] * 1.02)) if with_depth else None
    out = tpm.build_sweep_volume(torch.stack([q for q, _ in qs]), [s for _, s in qs],
                                 rays, R, t, cfg, nd)
    return out


@pytest.mark.parametrize("with_depth", [False, True])
def test_sweep_volume_matches_jax(scene, with_depth):
    j = _jax_volumes(scene, with_depth)
    jv = [np.asarray(j[4].astype(jnp.float32))]
    out = _port_volumes(scene, with_depth)
    tv = [out.float().numpy()] if not with_depth else [o.float().numpy() for o in out]
    if with_depth:
        jv.append(np.asarray(j[5].astype(jnp.float32)))
    for a, b in zip(tv, jv):
        assert a.shape == b.shape == (3, 16, H, W)
        diff = np.abs(a - b)
        assert np.mean(diff > 0) < 0.01, np.mean(diff > 0)
        assert np.all(diff <= np.abs(b) * 2.0 ** -7 + 1e-6), diff.max()


def _assert_costs_close(out, ref, geometric):
    d = np.abs(out - ref)
    assert d.max() <= 0.05, d.max()
    if geometric:
        assert np.mean(d <= 1e-3) >= 0.99, np.mean(d <= 1e-3)
    else:
        assert np.mean(d <= 2e-4) >= 0.999, np.mean(d <= 2e-4)


def _jax_draws(key, cfg):
    keys = jax.random.split(key, cfg.n_perturb + 2)
    lo, hi = np.log(cfg.min_depth), np.log(cfg.max_depth)
    return {
        "pert_u": [_t(jax.random.uniform(keys[i], (H, W))) for i in range(cfg.n_perturb)],
        "pert_n": [_t(jax.random.normal(jax.random.fold_in(keys[i], 7), (H, W, 3)))
                   for i in range(cfg.n_perturb)],
        "d_rand": _t(jnp.exp(jax.random.uniform(keys[-1], (H, W), minval=lo, maxval=hi))),
        "n_rand": _t(jax.random.normal(keys[-2], (H, W, 3))),
    }


@pytest.mark.parametrize("mode", ["sequential", "checkerboard_geometric"])
def test_one_step_with_injected_draws_matches_jax(scene, mode):
    geo = mode == "checkerboard_geometric"
    views, nd, R, t, vols, dvols = _jax_volumes(scene, geo)
    cfg_t, rays_t, R_t, t_t = _port_setup(scene)
    vols_t, dvols_t = (_bf16(vols), _bf16(dvols)) if geo else (_bf16(vols), None)
    jcfg = scene["cfg"]
    rays = jsp.pixel_ray_grid(H, W)
    gray = jnp.asarray(scene["grays"][0])
    rng = np.random.default_rng(5)
    depth = (scene["depths"][0] * rng.uniform(0.8, 1.25, (H, W))).astype(np.float32)
    normal = jpm.random_normals(jax.random.PRNGKey(1), rays)
    cost = jpm.multiview_cost(gray, views, rays, jnp.asarray(depth), normal, R, t,
                              jcfg, nd, vols=vols, dvols=dvols)
    cost_t = tpm.multiview_cost(_t(gray), rays_t, _t(depth)[None], _t(normal)[None],
                                R_t, t_t, cfg_t, tpm._patch_offsets(cfg_t),
                                vols_t, dvols_t)[0]
    _assert_costs_close(cost_t.numpy(), np.asarray(cost), geo)
    fixed = np.zeros((H, W), bool)
    fixed[::7, ::5] = True
    key = jax.random.PRNGKey(11)
    args = (gray, views, rays, jnp.asarray(depth), normal, cost, R, t, key,
            jnp.asarray(fixed), jcfg)
    targs = (_t(gray), rays_t, _t(depth), _t(normal), _t(cost), R_t, t_t,
             torch.from_numpy(fixed), cfg_t)
    draws = _jax_draws(key, jcfg)
    if geo:
        jd, jn, jc = jpm.checkerboard_step(*args, 1, nd, vols=vols, dvols=dvols)
        td, tn, tc = tpm.checkerboard_step(*targs, 1, vols_t, dvols_t, draws=draws)
    else:
        jd, jn, jc = jpm.sequential_step(*args, 0, nd, vols=vols)
        td, tn, tc = tpm.sequential_step(*targs, 0, vols_t, draws=draws)
    jd, jn = np.asarray(jd), np.asarray(jn)
    differ = (np.abs(td.numpy() - jd) > 1e-4 * jd) | \
        (np.abs(tn.numpy() - jn).max(-1) > 1e-4)
    assert np.mean(differ) < 0.02, np.mean(differ)
    assert np.mean(np.asarray(jd) != depth) > 0.1          # the step moved planes
    np.testing.assert_array_equal(td.numpy()[fixed], depth[fixed])
    same = ~differ
    _assert_costs_close(tc.numpy()[same], np.asarray(jc)[same], geo)


def test_init_depth_normal_with_injected_draws_matches_jax(scene):
    key = jax.random.PRNGKey(4)
    rays = jsp.pixel_ray_grid(H, W)
    cfg = jmvs.MVSConfig(pm=scene["cfg"], keep_lidar_constant=True)
    lidar = scene["depths"][0] * (np.random.default_rng(6).uniform(size=(H, W)) < 0.3)
    jd, jn, jf = jmvs.init_depth_normal(key, rays, jnp.asarray(lidar), cfg)
    k1, k2 = jax.random.split(key)
    lo, hi = np.log(cfg.pm.min_depth), np.log(cfg.pm.max_depth)
    draws = {"d_rand": _t(jnp.exp(jax.random.uniform(k1, (H, W), minval=lo, maxval=hi))),
             "n_rand": _t(jax.random.normal(k2, (H, W, 3)))}
    tcfg = tmvs.MVSConfig(pm=tpm.PatchMatchConfig(min_depth=cfg.pm.min_depth,
                                                  max_depth=cfg.pm.max_depth,
                                                  sweep_slices=cfg.pm.sweep_slices),
                          keep_lidar_constant=True)
    td, tn, tf = tmvs.init_depth_normal(tsp.pixel_ray_grid(H, W), _t(lidar), tcfg,
                                        draws=draws)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-6)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
