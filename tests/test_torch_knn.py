"""KNN kernels of the port (panovlm_tpu_torch/ops/knn.py) against the Pallas
kernels of the JAX package (panovlm_tpu/ops/pallas/knn.py, interpret mode on
the CPU), on the same seeded numpy inputs.

Tolerance: indices must be equal on every slot with a valid (< 1e29)
distance; d2 within rtol 1e-5 and atol 1e-5 (fp32 expanded form
|q|^2 + |t|^2 - 2 q.t evaluated in another order). Inputs are continuous
random values, so exact distance ties do not occur. The CUDA kernels are
held against the plain versions in test_torch_knn_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from panovlm_tpu.ops.pallas.knn import (knn_pallas_batched, knn_reference,
                                        knn_ring_pallas_batched)
from panovlm_tpu_torch.ops import knn as tknn
from knn_layouts import stage_layout

torch.set_num_threads(2)

B, Q, T = 2, 300, 700
DRS = (-2, -1, 1, 2)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Q, 3)).astype(np.float32)
    t = rng.normal(size=(B, T, 3)).astype(np.float32)
    qm = rng.random((B, Q)) > 0.1
    tm = rng.random((B, T)) > 0.1
    qr = rng.integers(0, 16, (B, Q)).astype(np.int32)
    tr = rng.integers(0, 16, (B, T)).astype(np.int32)
    return q, qm, t, tm, qr, tr


def _assert_match(d_ref, i_ref, d, i):
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    d, i = np.asarray(d), np.asarray(i)
    valid = d_ref < 1e29
    assert ((d >= 1e29) == ~valid).all()
    np.testing.assert_allclose(d[valid], d_ref[valid], rtol=1e-5, atol=1e-5)
    assert (i[valid] == i_ref[valid]).all()


@pytest.mark.parametrize("k", [5, 10])
def test_knn_reference_matches_pallas(k):
    q, qm, t, tm, _, _ = _inputs(k)
    d_pl, i_pl = knn_pallas_batched(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(t),
                                    jnp.asarray(tm), k=k, interpret=True)
    d, i = tknn.knn_reference(torch.from_numpy(q), torch.from_numpy(qm),
                              torch.from_numpy(t), torch.from_numpy(tm), k)
    _assert_match(d_pl, i_pl, d, i)


def test_knn_ring_reference_matches_pallas():
    q, qm, t, tm, qr, tr = _inputs(3)
    k = 10
    d_pl, i_pl, rd_pl, ri_pl = knn_ring_pallas_batched(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(t), jnp.asarray(tm),
        jnp.asarray(qr), jnp.asarray(tr), k=k, drs=DRS, interpret=True)
    d, i, rd, ri = tknn.knn_ring_reference(
        torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(t),
        torch.from_numpy(tm), torch.from_numpy(qr), torch.from_numpy(tr), k, DRS)
    _assert_match(d_pl, i_pl, d, i)
    _assert_match(rd_pl, ri_pl, rd, ri)
    # absent ring slots: 1e30 and index 0 in both
    absent = np.asarray(rd_pl) >= 1e29
    assert (np.asarray(ri)[absent] == 0).all() and (np.asarray(ri_pl)[absent] == 0).all()


@pytest.mark.parametrize("k", [5, 10])
def test_knn_reference_matches_pallas_on_the_stage_layout(k):
    """Queries as picks_to_buffer lays them out (interleaved invalid picks,
    a masked tail), targets as gather_masked does (a valid prefix ordered by
    ring, a zero-filled masked tail)."""
    q, qm, t, tm, _, _ = stage_layout(20 + k, B, Q, T)
    d_pl, i_pl = knn_pallas_batched(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(t),
                                    jnp.asarray(tm), k=k, interpret=True)
    d, i = tknn.knn(torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(t),
                    torch.from_numpy(tm), k)
    _assert_match(d_pl, i_pl, d, i)
    assert (d[torch.from_numpy(~qm)] >= 1e29).all()


def test_knn_ring_reference_matches_pallas_on_the_stage_layout():
    q, qm, t, tm, qr, tr = stage_layout(31, B, Q, T)
    d_pl, i_pl, rd_pl, ri_pl = knn_ring_pallas_batched(
        jnp.asarray(q), jnp.asarray(qm), jnp.asarray(t), jnp.asarray(tm),
        jnp.asarray(qr), jnp.asarray(tr), k=10, drs=DRS, interpret=True)
    d, i, rd, ri = tknn.knn_ring(
        torch.from_numpy(q), torch.from_numpy(qm), torch.from_numpy(t),
        torch.from_numpy(tm), torch.from_numpy(qr), torch.from_numpy(tr), 10, DRS)
    _assert_match(d_pl, i_pl, d, i)
    _assert_match(rd_pl, ri_pl, rd, ri)
    absent = np.asarray(rd_pl) >= 1e29
    assert (np.asarray(ri)[absent] == 0).all() and (np.asarray(ri_pl)[absent] == 0).all()
    # queries on rings 0 and 15 have two absent offsets each
    assert absent.any()


def test_cpu_wrappers_take_plain_path_without_counting():
    q, qm, t, tm, qr, tr = (torch.from_numpy(a) for a in _inputs(7))
    n0, r0 = tknn.knn.launches, tknn.knn_ring.launches
    d, i = tknn.knn(q, qm, t, tm, 5)
    d_ref, i_ref = tknn.knn_reference(q, qm, t, tm, 5)
    assert torch.equal(d, d_ref) and torch.equal(i, i_ref)
    out = tknn.knn_ring(q, qm, t, tm, qr, tr, 10)
    ref = tknn.knn_ring_reference(q, qm, t, tm, qr, tr, 10)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert (tknn.knn.launches, tknn.knn_ring.launches) == (n0, r0)


def test_masked_rows_and_short_targets():
    """Masked queries and slots beyond the valid targets hold 1e30 / 0."""
    q, qm, t, tm, _, _ = (torch.from_numpy(a) for a in _inputs(9))
    qm = torch.zeros_like(qm)
    qm[:, :10] = True
    tm = torch.zeros_like(tm)
    tm[:, :3] = True
    d, i = tknn.knn(q, qm, t, tm, 5)
    assert (d[:, 10:] >= 1e29).all() and (i[:, 10:] == 0).all()
    assert (d[:, :10, :3] < 1e29).all()
    assert (d[:, :10, 3:] >= 1e29).all() and (i[:, :10, 3:] == 0).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_knn_mutual_reference_matches_jax_forward_and_reverse(seed):
    """`knn_mutual` on the CPU (its plain version) against the JAX package's
    `knn_reference` called forward with k = 2 and reverse with k = 1, on
    unit non-negative (RootSIFT-like) descriptors at D = 128 with masked
    rows on both sides. Indices must be equal on every valid slot except
    near-ties (two float64 distances of the row within 1e-5, where the
    float32 rounding of either side may order them either way); d2 within
    rtol/atol 1e-5. Masked rows: 1e30 in both."""
    rng = np.random.default_rng(seed)
    Bn, N1, N2 = 2, 300, 260
    t = np.abs(rng.normal(size=(Bn, N2, 128))).astype(np.float32)
    q = t[:, rng.integers(0, N2, N1)] + 0.3 * np.abs(rng.normal(size=(Bn, N1, 128)))
    q = q.astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    qm, tm = rng.random((Bn, N1)) > 0.1, rng.random((Bn, N2)) > 0.1
    out = tknn.knn_mutual(*(torch.from_numpy(a) for a in (q, qm, t, tm)))
    for b in range(Bn):
        for (d, i), (x, xm, y, ym), k in (((out[0], out[1]), (q, qm, t, tm), 2),
                                          ((out[2], out[3]), (t, tm, q, qm), 1)):
            d_j, i_j = (np.asarray(a) for a in knn_reference(
                jnp.asarray(x[b]), jnp.asarray(xm[b]), jnp.asarray(y[b]),
                jnp.asarray(ym[b]), k=k))
            d_p, i_p = d[b].numpy(), i[b].numpy()
            valid = d_j < 1e29
            assert ((d_p >= 1e29) == ~valid).all()
            np.testing.assert_allclose(d_p[valid], d_j[valid], rtol=1e-5, atol=1e-5)
            full = ((x[b].astype(np.float64)[:, None] - y[b][None]) ** 2).sum(-1)
            rows, slots = np.nonzero(valid & (i_p != i_j))
            gap = np.abs(full[rows, i_p[rows, slots]] - full[rows, i_j[rows, slots]])
            assert (gap <= 1e-5).all(), gap.max()


@pytest.mark.parametrize("bad", ["dim", "k", "dtype", "mask"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, qm, t, tm, _, _ = (torch.from_numpy(a) for a in _inputs(11))
    k = 5
    if bad == "dim":
        q, t = torch.zeros(B, Q, 6), torch.zeros(B, T, 6)   # neither <= 4 nor a multiple of 4
    elif bad == "k":
        k = 17
    elif bad == "dtype":
        q = q.double()
    else:
        qm = qm.to(torch.uint8)
    with pytest.raises((ValueError, TypeError)):
        tknn.knn(q, qm, t, tm, k)
