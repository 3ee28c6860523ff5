"""ROADMAP F9: the port's scattered float sums that decide poses and fused
clouds go through `ops/exact.index_sum`, whose bits depend on neither
the device nor the order of the terms. On the CPU, against the float sums
they replace:

  * the sites (index_sum itself is tested in tests/test_torch_fixed_sums.py):
    the LM normal equations (a bundle-adjustment problem agrees with the
    float index_add_ assembly within 1e-5 relative, and five Schur LM
    iterations end within 5e-5, absolute and relative, of each other: the
    chordal problem leaves its scale free, so the two drift along it),
    translation averaging's A^T (1e-5), the L1-ADMM Laplacian and A^T
    (1e-6), and voxel_downsample, whose centroids and colours keep their
    bits when the input points are shuffled and agree with the float sums
    within 1e-6.
"""

import numpy as np
import pytest
import torch

from panovlm_tpu_torch.ops import exact
from panovlm_tpu_torch.sensors import velodyne
from panovlm_tpu_torch.solver import l1_admm

torch.set_num_threads(2)


def _float_lm(monkeypatch):
    """Patch the LM module's exact sums back to float index_add_."""
    from panovlm_tpu_torch.solver import lm

    def float_sum(n, index, src):
        return torch.zeros((n, *src.shape[1:]), dtype=src.dtype).index_add_(0, index, src)
    monkeypatch.setattr(lm, "index_sum", float_sum)
    return lm


def _ba_problem(rng, n=5, T=80):
    from panovlm_tpu_torch.solver import residuals
    from panovlm_tpu_torch.solver.lm import ResidualBlock
    pts = rng.uniform(-3, 3, (T, 3)).astype(np.float32)
    pts[:, 2] += 6
    poses = np.zeros((n, 6), np.float32)
    poses[:, 3] = np.arange(n) * 0.3
    ti = np.repeat(np.arange(T), n)
    ci = np.tile(np.arange(n), T)
    pc = pts[ti] + poses[ci, 3:]
    obs = (pc / np.linalg.norm(pc, axis=1, keepdims=True)).astype(np.float32)
    obs += rng.normal(size=obs.shape).astype(np.float32) * 1e-3
    groups = {"cam": torch.from_numpy(poses + rng.normal(size=poses.shape).astype(np.float32)
                                      * 0.01),
              "pts": torch.from_numpy(pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05)}
    blk = ResidualBlock(residuals.reproj_chordal, ("cam", "pts"),
                        (torch.from_numpy(ci), torch.from_numpy(ti)), (torch.from_numpy(obs),),
                        torch.ones(len(ti)), torch.ones(len(ti), dtype=torch.bool),
                        loss="huber", loss_scale=0.05)
    fixed = {"cam": torch.zeros((n, 6), dtype=torch.bool),
             "pts": torch.zeros((T, 3), dtype=torch.bool)}
    fixed["cam"][0] = True
    return groups, (blk,), fixed


def test_lm_exact_sums_match_float_sums(monkeypatch):
    from panovlm_tpu_torch.solver import lm
    groups, blocks, fixed = _ba_problem(np.random.default_rng(3))
    rows = [lm._valid_rows(b) for b in blocks]
    offs, P = lm._flat_layout(groups)
    exact_lin = lm._linearize(groups, rows, offs, P)
    exact_out, _ = lm.solve_lm(groups, blocks, fixed, lm.LMOptions(max_iters=5), schur="pts")
    flm = _float_lm(monkeypatch)
    float_lin = flm._linearize(groups, rows, offs, P)
    float_out, _ = flm.solve_lm(groups, blocks, fixed, flm.LMOptions(max_iters=5), schur="pts")
    for a, b in zip(exact_lin[1:], float_lin[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(b.abs().max()))
    for k in groups:
        np.testing.assert_allclose(exact_out[k].numpy(), float_out[k].numpy(), rtol=5e-5,
                                   atol=5e-5)


def test_l1_admm_sums_match_float_sums():
    rng = np.random.default_rng(4)
    n, m = 12, 40
    pi, pj = rng.integers(0, n, m), rng.integers(0, n, m)
    gi, gj, mi, mj = l1_admm._reduced_graph(pi, pj, 0, "cpu")
    v = torch.from_numpy(rng.normal(size=(m, 3)).astype(np.float32))
    ref = torch.zeros((n - 1, 3)).index_add_(0, gj, v * mj[:, None]).index_add_(
        0, gi, -v * mi[:, None])
    np.testing.assert_allclose(l1_admm._apply_At(v, gi, gj, mi, mj, n - 1).numpy(),
                               ref.numpy(), atol=1e-6)
    w = torch.from_numpy(rng.random((m, 3)).astype(np.float32))
    L = l1_admm._laplacian(gi, gj, mi, mj, n - 1, w)
    Lf = torch.zeros((3, (n - 1) ** 2))
    for a, b, mm in ((gi, gi, mi * mi), (gj, gj, mj * mj), (gi, gj, -mi * mj),
                     (gj, gi, -mi * mj)):
        Lf.index_add_(1, a * (n - 1) + b, w.T * mm[None])
    np.testing.assert_allclose(L.numpy(), Lf.reshape(3, n - 1, n - 1).numpy()
                               + 1e-8 * np.eye(n - 1), atol=1e-6)


def test_translation_averaging_dlt_is_order_free_in_its_sums():
    from panovlm_tpu_torch.models import translation_averaging as ta
    rng = np.random.default_rng(5)
    n = 8
    aa = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    pi, pj = np.triu_indices(n, 1)
    rel_aa = (rng.normal(size=(len(pi), 3)) * 0.1).astype(np.float32)
    rel_t = rng.normal(size=(len(pi), 3)).astype(np.float32)
    t1, s1 = ta.translation_averaging_dlt(aa, pi, pj, rel_aa, rel_t)
    assert np.isfinite(t1).all() and np.isfinite(s1).all()
    t2, s2 = ta.translation_averaging_dlt(aa, pi, pj, rel_aa, rel_t)
    np.testing.assert_array_equal(t1, t2)


def test_voxel_downsample_ignores_point_order():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-2, 2, (20000, 3)).astype(np.float32)
    aux = rng.random((20000, 3)).astype(np.float32)
    mask = rng.random(20000) < 0.9
    a = velodyne.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(mask),
                                  aux=torch.from_numpy(aux), leaf=0.3)
    perm = rng.permutation(20000)
    b = velodyne.voxel_downsample(torch.from_numpy(pts[perm]), torch.from_numpy(mask[perm]),
                                  aux=torch.from_numpy(aux[perm]), leaf=0.3)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # against float64 means per voxel
    vox = np.floor(pts[mask] / 0.3).astype(np.int64)
    keys, inv = np.unique(vox, axis=0, return_inverse=True)
    ref = np.zeros((len(keys), 3))
    np.add.at(ref, inv.ravel(), pts[mask].astype(np.float64))
    ref /= np.bincount(inv.ravel())[:, None]
    got = a[0][a[1]].numpy()
    assert len(got) == len(keys)
    np.testing.assert_allclose(np.sort(got, axis=0), np.sort(ref, axis=0), atol=1e-6)
