"""Odometry's two options in the port (panovlm_tpu_torch/sensors/velodyne.py):
ReOrderVLP2's ring repair (`lidar_ring_repair`, `repair_ring_conflicts`) and
DOUBLE_EXTRACTION (`extraction_method = 2`, `combine_edges_hysteresis`),
against the JAX package on the same numpy inputs.

Tolerance: every ring, mask, label and integer buffer bit-equal, every
gathered coordinate exact, the line fits within rtol 1e-5, atol 1e-6 (the
PCA fits sum in another order), as in tests/test_torch_velodyne.py. Both
functions decide in integers only; the repair's elevation ring is the
range image's float arithmetic (XLA's fused multiply-add), bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import synthetic
from ring_scans import firing_column, jittered_scan, probe
from panovlm_tpu.sensors import velodyne as jvd
from panovlm_tpu_torch.sensors import velodyne as tvd

torch.set_num_threads(2)

GATHERED = ("sharp", "less_sharp", "flat", "less_flat")
def _jax_repair(pts, mask):
    return np.stack([np.asarray(jvd.repair_ring_conflicts(jnp.asarray(p), jnp.asarray(m)))
                     for p, m in zip(pts, mask)])


def _port_repair(pts, mask):
    return tvd.repair_ring_conflicts(torch.from_numpy(pts), torch.from_numpy(mask)).numpy()


def _padded(clouds, cap):
    pads = [jvd.pad_points(c, cap) for c in clouds]
    return np.stack([p for p, _ in pads]), np.stack([m for _, m in pads])


@pytest.fixture(scope="module")
def scans():
    raw, _ = synthetic.make_trajectory_scans(n_scans=2, h_steps=900)
    return _padded([jvd.preprocess_cloud(s)[0] for s in raw], 16384)


def test_repair_fixes_the_probe_column():
    pts, expect = probe()
    pts, mask = _padded([pts], 96)
    out = _port_repair(pts, mask)
    np.testing.assert_array_equal(out[0, :len(expect)], expect)
    assert (out[0, len(expect):] == -1).all()
    np.testing.assert_array_equal(out, _jax_repair(pts, mask))


def test_repair_leaves_the_clean_sweep_alone(scans):
    pts, mask = scans
    out = _port_repair(pts, mask)
    ring = tvd.elevation_ring(torch.from_numpy(pts)).numpy()
    ok = mask & (ring >= 0) & (ring < 16)
    np.testing.assert_array_equal(out[ok], ring[ok])
    assert (out[~ok] == -1).all()
    np.testing.assert_array_equal(out, _jax_repair(pts, mask))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repair_matches_jax_on_jittered_scans(seed):
    pts, mask = _padded([jittered_scan(seed), jittered_scan(seed + 100)], 12288)
    out = _port_repair(pts, mask)
    ring = tvd.elevation_ring(torch.from_numpy(pts)).numpy()
    assert ((out != ring) & mask).sum() > 20          # conflicts were repaired
    np.testing.assert_array_equal(out, _jax_repair(pts, mask))


def test_repair_past_max_cols_matches_jax():
    """4,400 two-point firing columns, every 9th a conflict (two returns on
    ring 8), so that the columns past max_cols = 4096 meet the JAX
    package's wrapped index -1: both packages repair the conflicts of the
    first 4096 columns only (ring 8 -> 9 for the second return)."""
    n_cols = 4400
    cols = [firing_column(2 * np.pi * k / n_cols, [8, 8] if k % 9 == 0 else [0, 1])
            for k in range(n_cols)]
    pts, mask = _padded([np.concatenate(cols)], 2 * n_cols)
    out = _port_repair(pts, mask)
    np.testing.assert_array_equal(out, _jax_repair(pts, mask))
    ring = tvd.elevation_ring(torch.from_numpy(pts)).numpy()
    fixed = np.nonzero(out[0] != ring[0])[0]
    np.testing.assert_array_equal(fixed, [2 * k + 1 for k in range(0, 4096, 9)])
    assert (out[0, fixed] == 9).all()


def test_hysteresis_three_blobs():
    """The case of tests/test_velodyne.py: a seeded blob is kept whole, a
    loose-only blob and a seeded blob of two cells are dropped."""
    strict = np.zeros((1, 16, 64), bool)
    loose = np.zeros((1, 16, 64), bool)
    strict[0, 4, 10] = True
    loose[0, 4, 8:14] = True
    loose[0, 5, 9:13] = True
    loose[0, 10, 40:48] = True
    strict[0, 14, 30] = True
    loose[0, 14, 31] = True
    keep, lab = tvd.combine_edges_hysteresis(torch.from_numpy(strict),
                                             torch.from_numpy(loose))
    keep = keep.numpy()[0]
    assert keep[4, 8:14].all() and keep[5, 9:13].all()
    assert not keep[10, 40:48].any() and not keep[14, 30:32].any()
    jk, jl = jvd.combine_edges_hysteresis(jnp.asarray(strict[0]), jnp.asarray(loose[0]))
    np.testing.assert_array_equal(keep, np.asarray(jk))
    np.testing.assert_array_equal(lab.numpy()[0], np.asarray(jl))


@pytest.mark.parametrize("seed", [0, 1])
def test_hysteresis_matches_jax_on_random_images(seed):
    rng = np.random.default_rng(seed)
    loose = rng.random((3, 16, 300)) < 0.12
    strict = loose & (rng.random(loose.shape) < 0.15)
    keep, lab = tvd.combine_edges_hysteresis(torch.from_numpy(strict),
                                             torch.from_numpy(loose))
    for b in range(3):
        jk, jl = jvd.combine_edges_hysteresis(jnp.asarray(strict[b]), jnp.asarray(loose[b]))
        np.testing.assert_array_equal(keep.numpy()[b], np.asarray(jk))
        np.testing.assert_array_equal(lab.numpy()[b], np.asarray(jl))
    assert 0 < keep.sum() < loose.sum()


@pytest.mark.parametrize("kw", [{"method": 2}, {"repair_rings": True},
                                {"method": 2, "repair_rings": True}],
                         ids=["method2", "repair", "both"])
def test_extract_features_matches_jax(scans, kw):
    pts, msk = scans
    jf = jax.jit(jax.vmap(lambda p, m: jvd.extract_features(p, m, **kw)[0]))(pts, msk)
    tf = tvd.extract_features(torch.from_numpy(pts), torch.from_numpy(msk), **kw)
    assert set(jf._fields) == set(tf)
    assert np.asarray(jf.less_sharp_mask).sum() > 50 and np.asarray(jf.line_mask).sum() > 3
    for k in jf._fields:
        a, b = np.asarray(getattr(jf, k)), tf[k].numpy()
        assert a.shape == b.shape, k
        if a.dtype == bool or np.issubdtype(a.dtype, np.integer) or k in GATHERED:
            bad = np.argwhere(a != b)
            assert len(bad) == 0, f"{k}: {len(bad)} mismatches, first at {bad[:5].tolist()}"
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=k)
