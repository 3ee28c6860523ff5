"""The port's SfM modules (panovlm_tpu_torch/models/sfm.py and what it
calls) against the JAX package on the same numpy inputs: a synthetic scene
of 8 frames and 300 points whose descriptors are shared across views (the
scene of tests/test_sfm_pipeline.py), 128-d unit descriptors, bearings with
~0.03 deg noise.

Tolerances, each stated at its assertion:
  * matching: the same set of matches per pair (no ratio of this scene is
    within rounding of 0.36 and no top two tie) and distances within 1e-5;
    the JAX default path forms 2 - 2 d1.d2 and the kernel |d1|^2 + |d2|^2 -
    2 d1.d2, so the order by distance may swap matches whose distances
    agree to rounding;
  * relative poses with jax.random's AC-RANSAC draws injected: the same
    accepted pairs, rotations within 0.05 deg and unit translations within
    1e-3 of each other (float32 factorizations in a different order);
  * graph filters, spanning tree and tracks: exact;
  * rotation averaging (L1 and L2), translation averaging (softl1) and the
    Schur global BA (chordal and pixel residuals): poses within 1e-3 of
    each other in axis-angle and in translation (a few LM iterations of
    float32 rounding apart).
The BA problems stay below the 65,536 observation rows above which the JAX
solver raises (ROADMAP F1).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation as ScR

from panovlm_tpu.models import rotation_averaging as ra
from panovlm_tpu.models import sfm
from panovlm_tpu.models import translation_averaging as ta
from panovlm_tpu.ops import spherical
from panovlm_tpu.utils import tracks as trk
from panovlm_tpu.utils.sift import _match_descriptors
from panovlm_tpu_torch.models import rotation_averaging as tra
from panovlm_tpu_torch.models import sfm as tsfm
from panovlm_tpu_torch.models import translation_averaging as tta
from panovlm_tpu_torch.utils import tracks as ttrk
from panovlm_tpu_torch.utils.sift import match_descriptors as tmatch

torch.set_num_threads(2)

ROWS, COLS = 256, 512
N_FRAMES, N_POINTS = 8, 300


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-4, 4, (N_POINTS, 3)).astype(np.float32)
    pts[:, 1] *= 0.4
    aa = np.cumsum(rng.normal(size=(N_FRAMES, 3)) * 0.02, axis=0).astype(np.float32)
    aa[0] = 0
    C = np.cumsum(rng.normal(size=(N_FRAMES, 3)) * np.array([0.25, 0.05, 0.25]),
                  axis=0).astype(np.float32)
    C[0] = 0
    R = ScR.from_rotvec(aa).as_matrix().astype(np.float32)
    t = -np.einsum("nij,nj->ni", R, C)
    desc_gt = rng.normal(size=(N_POINTS, 128)).astype(np.float32)
    desc_gt /= np.linalg.norm(desc_gt, axis=1, keepdims=True)
    bearings = np.zeros((N_FRAMES, N_POINTS, 3), np.float32)
    descs = np.zeros((N_FRAMES, N_POINTS, 128), np.float32)
    uv = np.zeros((N_FRAMES, N_POINTS, 2), np.float32)
    for i in range(N_FRAMES):
        b = pts @ R[i].T + t[i]
        b /= np.linalg.norm(b, axis=1, keepdims=True)
        b += rng.normal(size=b.shape) * 5e-4
        bearings[i] = b / np.linalg.norm(b, axis=1, keepdims=True)
        uv[i] = np.asarray(spherical.cam_to_image(jnp.asarray(bearings[i]), ROWS, COLS))
        d = desc_gt + rng.normal(size=desc_gt.shape) * 0.01
        descs[i] = d / np.linalg.norm(d, axis=1, keepdims=True)
    fmask = np.ones((N_FRAMES, N_POINTS), bool)
    fmask[:, -20:] = False          # padded feature slots
    cfg = sfm.SfMConfig(contiguous_window=4, max_matches=512, ransac_hypotheses=200,
                        min_inliers=30, match_max_dist_factor=10.0)
    tcfg = tsfm.SfMConfig(**{k: v for k, v in cfg._asdict().items()
                             if k in tsfm.SfMConfig._fields})
    pi, pj = sfm.init_image_pairs(N_FRAMES, cfg)
    matches = sfm.match_all_pairs(jnp.asarray(descs), jnp.asarray(fmask), pi, pj, cfg)
    rel = sfm.relative_poses(jnp.asarray(bearings), matches["idx"], matches["mask"],
                             pi, pj, cfg)
    return dict(pts=pts, poses_gt=np.concatenate([aa, t], 1), C=C, bearings=bearings,
                descs=descs, uv=uv, fmask=fmask, cfg=cfg, tcfg=tcfg, pi=pi, pj=pj,
                matches={k: np.asarray(v) for k, v in matches.items()},
                rel={k: np.asarray(v) for k, v in rel.items()})


@pytest.mark.parametrize("use_kernel", [False, True])
def test_match_descriptors_matches_jax(scene, use_kernel):
    """Both JAX paths (einsum default; the Pallas kernel in interpret mode)
    against the port's batched matcher: identical outputs."""
    d, m = scene["descs"], scene["fmask"]
    if use_kernel:
        import panovlm_tpu.ops.pallas.knn as knn_mod
        orig = knn_mod.knn_pallas
        knn_mod.knn_pallas = lambda *a_, **k_: orig(*a_, interpret=True, **k_)
    try:
        ref = [_match_descriptors(jnp.asarray(d[0]), jnp.asarray(m[0]), jnp.asarray(d[j]),
                                  jnp.asarray(m[j]), max_matches=512, use_kernel=use_kernel)
               for j in (1, 2)]
    finally:
        if use_kernel:
            knn_mod.knn_pallas = orig
    out = tmatch(_t(d[[0, 0]]), _t(m[[0, 0]]), _t(d[[1, 2]]), _t(m[[1, 2]]), max_matches=512)
    for b, r in enumerate(ref):
        _same_matches(out["idx"][b].numpy(), out["mask"][b].numpy(), out["dist"][b].numpy(),
                      np.asarray(r["idx"]), np.asarray(r["mask"]), np.asarray(r["dist"]))


def _same_matches(idx, mask, dist, idx_r, mask_r, dist_r):
    assert mask.sum() == mask_r.sum() > 0
    np.testing.assert_array_equal(mask, mask_r)
    key = lambda a, m: np.lexsort((a[m][:, 1], a[m][:, 0]))
    np.testing.assert_array_equal(idx[mask][key(idx, mask)], idx_r[mask_r][key(idx_r, mask_r)])
    np.testing.assert_allclose(dist, dist_r, atol=1e-5)


def test_match_all_pairs_matches_jax(scene):
    out = tsfm.match_all_pairs(_t(scene["descs"]), _t(scene["fmask"]), scene["pi"],
                               scene["pj"], scene["tcfg"], batch=3)
    ref = scene["matches"]
    np.testing.assert_array_equal(out["pair_ok"].numpy(), ref["pair_ok"])
    for p in range(len(scene["pi"])):
        _same_matches(out["idx"][p].numpy(), out["mask"][p].numpy(), out["dist"][p].numpy(),
                      ref["idx"][p], ref["mask"][p], ref["dist"][p])


def _jax_draws(mask, n_hyp):
    """jax.random's AC-RANSAC draws of sfm.relative_poses (key = row)."""
    out = []
    for p in range(len(mask)):
        key = jax.random.fold_in(jax.random.PRNGKey(0), p)
        out.append(np.asarray(jax.random.randint(key, (n_hyp, 8), 0,
                                                 max(int(mask[p].sum()), 1))))
    return np.stack(out).astype(np.int64)


def test_relative_poses_with_injected_draws_match_jax(scene):
    m, r = scene["matches"], scene["rel"]
    out = tsfm.relative_poses(_t(scene["bearings"]), _t(m["idx"]), _t(m["mask"]),
                              scene["pi"], scene["pj"], scene["tcfg"],
                              draws=_t(_jax_draws(m["mask"], scene["cfg"].ransac_hypotheses)))
    out = {k: v.numpy() for k, v in out.items()}
    np.testing.assert_array_equal(out["ok"], r["ok"])
    assert r["ok"].sum() >= 10
    ok = r["ok"]
    R_t = ScR.from_rotvec(out["rel_aa"][ok])
    R_j = ScR.from_rotvec(r["rel_aa"][ok])
    assert np.degrees((R_t * R_j.inv()).magnitude()).max() < 0.05     # deg
    assert np.abs(out["rel_t"][ok] - r["rel_t"][ok]).max() < 1e-3
    assert np.abs(out["n_inliers"][ok] - r["n_inliers"][ok]).max() <= 2
    assert (out["tri_mask"] == r["tri_mask"]).mean() > 0.99


def test_relative_poses_own_draws_recover_the_scene(scene):
    """With the port's own draws (torch.Generator per pair), the relative
    rotations match the ground truth as the JAX ones do (< 0.2 deg)."""
    m = scene["matches"]
    out = tsfm.relative_poses(_t(scene["bearings"]), _t(m["idx"]), _t(m["mask"]),
                              scene["pi"], scene["pj"], scene["tcfg"])
    ok = out["ok"].numpy()
    assert ok.sum() >= scene["rel"]["ok"].sum() - 1
    aa = scene["poses_gt"][:, :3]
    Ri = ScR.from_rotvec(aa[scene["pi"]])
    Rj = ScR.from_rotvec(aa[scene["pj"]])
    err = (ScR.from_rotvec(out["rel_aa"].numpy()) * (Rj * Ri.inv()).inv()).magnitude()
    assert np.degrees(err[ok]).max() < 0.2


def _graph_case(seed):
    rng = np.random.default_rng(seed)
    n = 12
    pi, pj = np.triu_indices(n, 1)
    sel = rng.random(len(pi)) < 0.45
    pi, pj = pi[sel].astype(np.int32), pj[sel].astype(np.int32)
    aa = rng.normal(size=(n, 3)) * 0.3
    Rg = ScR.from_rotvec(aa)
    rel = (Rg[pj] * Rg[pi].inv()).as_rotvec()
    noisy = rng.random(len(pi)) < 0.2
    rel[noisy] += rng.normal(size=(noisy.sum(), 3)) * 0.3
    ok = rng.random(len(pi)) < 0.9
    w = rng.integers(30, 60, len(pi))       # repeated weights: ties to resolve
    return n, pi, pj, rel.astype(np.float32), ok, w


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_graph_filters_and_spanning_tree_equal_jax(seed):
    n, pi, pj, rel, ok, w = _graph_case(seed)
    keep_j = sfm.filter_by_triplet(pi, pj, rel, ok)
    keep_t = tsfm.filter_by_triplet(pi, pj, rel, ok)
    np.testing.assert_array_equal(keep_t, keep_j)
    for a, b in zip(sfm.largest_biconnected(pi, pj, keep_j, n),
                    tsfm.largest_biconnected(pi, pj, keep_j, n)):
        np.testing.assert_array_equal(b, a)
    for a, b in zip(ra.spanning_tree_init(n, pi, pj, rel, w),
                    tra.spanning_tree_init(n, pi, pj, rel, w)):
        np.testing.assert_array_equal(b, a)


def test_build_tracks_equals_jax(scene):
    m = scene["matches"]
    pm = [(int(a), int(b), m["idx"][k][m["mask"][k]])
          for k, (a, b) in enumerate(zip(scene["pi"], scene["pj"]))]
    for a, b in zip(trk.build_tracks(pm, [N_POINTS] * N_FRAMES, min_length=3),
                    ttrk.build_tracks(pm, [N_POINTS] * N_FRAMES, min_length=3)):
        np.testing.assert_array_equal(b, a)


def _pose_close(a, b, tol=1e-3):
    dR = (ScR.from_rotvec(np.asarray(a)[:, :3]) * ScR.from_rotvec(np.asarray(b)[:, :3]).inv())
    assert dR.magnitude().max() < tol, dR.magnitude().max()
    if np.asarray(a).shape[1] == 6:
        assert np.abs(np.asarray(a)[:, 3:] - np.asarray(b)[:, 3:]).max() < tol


@pytest.mark.parametrize("method", [1, 2])
def test_rotation_averaging_matches_jax(scene, method):
    r, ok = scene["rel"], scene["rel"]["ok"]
    args = (N_FRAMES, scene["pi"][ok], scene["pj"][ok], r["rel_aa"][ok])
    aa_j, valid_j, keep_j = ra.rotation_averaging(*args, weights=r["n_inliers"][ok],
                                                  method=method)
    aa_t, valid_t, keep_t = tra.rotation_averaging(*args, weights=r["n_inliers"][ok],
                                                   method=method)
    np.testing.assert_array_equal(valid_t, valid_j)
    np.testing.assert_array_equal(keep_t, keep_j)
    _pose_close(aa_t, aa_j)


def test_translation_averaging_softl1_matches_jax(scene):
    r, ok = scene["rel"], scene["rel"]["ok"]
    pi, pj = scene["pi"][ok], scene["pj"][ok]
    C = scene["C"]
    scales = np.linalg.norm(C[pj] - C[pi], axis=1).astype(np.float32)
    scales[::4] = -1.0                       # some pairs without a depth scale
    aa = scene["poses_gt"][:, :3]
    args = (aa, pi, pj, r["rel_aa"][ok], r["rel_t"][ok], scales)
    t_j, s_j = ta.translation_averaging(*args, method="softl1", lower_scale_ratio=1.0)
    t_t, s_t = tta.translation_averaging(*args, method="softl1", lower_scale_ratio=1.0)
    assert np.abs(t_t - t_j).max() < 1e-3
    assert np.abs(s_t - s_j).max() < 1e-3


@pytest.fixture(scope="module")
def ba_problem(scene):
    m = scene["matches"]
    pm = [(int(a), int(b), m["idx"][k][m["mask"][k]])
          for k, (a, b) in enumerate(zip(scene["pi"], scene["pj"]))]
    timg, tfeat, tmask = trk.build_tracks(pm, [N_POINTS] * N_FRAMES, min_length=3)
    rng = np.random.default_rng(5)
    poses0 = scene["poses_gt"].copy()
    poses0[1:] += rng.normal(size=poses0[1:].shape).astype(np.float32) * 0.01
    X, x_ok = sfm.estimate_structure(poses0, scene["bearings"], timg, tfeat, tmask,
                                     scene["cfg"])
    assert timg.size < 65536
    return poses0, np.asarray(X), np.asarray(x_ok), timg, tfeat, tmask


def test_estimate_structure_and_pixel_filter_match_jax(scene, ba_problem):
    poses0, X, x_ok, timg, tfeat, tmask = ba_problem
    Xt, okt = tsfm.estimate_structure(_t(poses0), _t(scene["bearings"]), _t(timg),
                                      _t(tfeat), _t(tmask), scene["tcfg"])
    np.testing.assert_array_equal(okt.numpy(), x_ok)
    # 3x3 normal equations of short-baseline rays: 1 mm at a few metres
    np.testing.assert_allclose(Xt.numpy()[x_ok], X[x_ok], atol=1e-3)
    ref = np.asarray(sfm.filter_tracks_pixel_residual(poses0, X, timg, tfeat, tmask,
                                                      scene["uv"], x_ok, 2.0, ROWS, COLS))
    out = tsfm.filter_tracks_pixel_residual(_t(poses0), _t(X), _t(timg), _t(tfeat),
                                            _t(tmask), _t(scene["uv"]), _t(x_ok), 2.0,
                                            ROWS, COLS)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("residual", ["chordal", "pixel"])
def test_schur_global_ba_matches_jax(scene, ba_problem, residual):
    poses0, X, x_ok, timg, tfeat, tmask = ba_problem
    fv = np.ones(N_FRAMES, bool)
    kw = dict(residual=residual, uv=scene["uv"], rows=ROWS, cols=COLS)
    p_j, X_j, info_j = sfm.global_ba(poses0, X, timg, tfeat, tmask, scene["bearings"],
                                     x_ok, fv, scene["cfg"], **kw)
    p_t, X_t, info_t = tsfm.global_ba(poses0, X, timg, tfeat, tmask, scene["bearings"],
                                      x_ok, fv, scene["tcfg"], **kw)
    assert float(info_t["final_cost"]) < 0.2 * float(info_t["initial_cost"])
    _pose_close(p_t, np.asarray(p_j))
    assert np.abs(X_t[x_ok] - np.asarray(X_j)[x_ok]).max() < 1e-2


def test_vlad_pairs_with_injected_draws_match_jax(scene):
    """VLAD codebook, embeddings and neighbour pairs with jax.random's two
    draws (descriptor sample, initial centres) injected: the same pairs,
    embeddings within 1e-4."""
    from panovlm_tpu.models import vlad as jvlad
    from panovlm_tpu_torch.models import vlad as tvlad
    d, m = scene["descs"], scene["fmask"]
    kw = dict(n_neighbors=3, n_centers=16, sample=1000)
    pi_j, pj_j, emb_j = jvlad.vlad_pairs(d, m, **kw)
    key = jax.random.PRNGKey(0)
    flat_m = m.reshape(-1)
    sel = np.asarray(jax.random.choice(key, flat_m.shape[0], (1000,), replace=False))
    p = flat_m[sel].astype(np.float32)
    init = np.asarray(jax.random.choice(key, 1000, (16,), replace=False,
                                        p=jnp.asarray(p / max(p.sum(), 1))))
    pi_t, pj_t, emb_t = tvlad.vlad_pairs(_t(d), _t(m), draws=(_t(sel), _t(init)), **kw)
    np.testing.assert_array_equal(pi_t, pi_j)
    np.testing.assert_array_equal(pj_t, pj_j)
    np.testing.assert_allclose(emb_t, np.asarray(emb_j), atol=1e-4)
