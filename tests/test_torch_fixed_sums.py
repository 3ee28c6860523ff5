"""The reproducible scattered sums of the port (panovlm_tpu_torch/ops/exact.py
`index_sum`, `scatter_sum`), which the VLAD proposal and the device SIFT use
so that the SfM pair set is the same on every run (ROADMAP F8), and the
solvers and the voxel grid use for F9 (tests/test_torch_exact_sums.py),
against the float `index_add_` / `scatter_add_` sums they replace, on the
CPU.

Tolerances: each term is rounded to a multiple of 2^(e - 62), where 2^e
bounds the largest |term|, so the fixed-point sum lies within (terms) x
2^-62 x max|term| of the exact sum, and is then rounded once to float32:
within that plus 2^-24 relative of the float64 sum, also for terms of
magnitudes 1e-6..1e6 mixed, whatever their order. The float sums it replaces round at every term: VLAD
codebooks and embeddings agree within 1e-5 and give the same pairs;
descriptors agree within 1e-5 on at least 99 % of the keypoints (an
orientation-histogram peak within rounding of its neighbour may move a
whole descriptor) and the keypoints themselves are identical.
"""

import numpy as np
import pytest
import torch

from panovlm_tpu_torch.models import vlad
from panovlm_tpu_torch.ops import exact, sift_device

from synthetic import render_panorama

torch.set_num_threads(2)


def _float_index_sum(n, index, src):
    return torch.zeros((n, *src.shape[1:]), dtype=src.dtype).index_add_(0, index, src)


def _float_scatter_sum(n, parts):
    acc = None
    for index, src in parts:
        if acc is None:
            acc = torch.zeros((*src.shape[:-1], n), dtype=src.dtype)
        acc.scatter_add_(-1, index, src)
    return acc


def test_index_sum_does_not_depend_on_the_order_of_terms():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(5000, 16)).astype(np.float32)
    idx = rng.integers(0, 37, 5000)
    a = exact.index_sum(37, torch.from_numpy(idx), torch.from_numpy(src))
    perm = rng.permutation(5000)
    b = exact.index_sum(37, torch.from_numpy(idx[perm]), torch.from_numpy(src[perm]))
    assert torch.equal(a, b)
    ref = np.zeros((37, 16))
    np.add.at(ref, idx, src.astype(np.float64))
    bound = np.abs(ref) * 2.0 ** -24 + 5000 * 2.0 ** -62 * np.abs(src).max()
    assert (np.abs(a.numpy() - ref) <= bound).all()


def _terms(rng, n, shape=()):
    mag = 10.0 ** rng.uniform(-6, 6, (n,) + (1,) * len(shape))
    return (rng.normal(size=(n,) + shape) * mag).astype(np.float32)


@pytest.mark.parametrize("shape", [(), (3,), (2, 4)])
def test_index_sum_matches_float64_and_ignores_order(shape):
    rng = np.random.default_rng(len(shape))
    n, dest = 20000, 97
    src = _terms(rng, n, shape)
    idx = rng.integers(0, dest, n)
    out = exact.index_sum(dest, torch.from_numpy(idx), torch.from_numpy(src))
    ref = np.zeros((dest,) + shape)
    np.add.at(ref, idx, src.astype(np.float64))
    bound = np.abs(ref) * 2.0 ** -24 + n * 2.0 ** -62 * np.abs(src).max()
    assert (np.abs(out.numpy() - ref) <= bound).all()
    perm = rng.permutation(n)
    again = exact.index_sum(dest, torch.from_numpy(idx[perm]), torch.from_numpy(src[perm]))
    assert torch.equal(out, again)
    fl = torch.zeros((dest,) + shape).index_add_(0, torch.from_numpy(idx), torch.from_numpy(src))
    np.testing.assert_allclose(out.numpy(), fl.numpy(), rtol=1e-4, atol=1e-6 * np.abs(src).max())


def test_index_sum_edge_cases():
    z = exact.index_sum(4, torch.zeros(0, dtype=torch.int64), torch.zeros(0))
    assert torch.equal(z, torch.zeros(4))
    z = exact.index_sum(3, torch.tensor([0, 2, 2]), torch.zeros(3))
    assert torch.equal(z, torch.zeros(3))
    tiny = torch.tensor([1e-30, 3e-30, -1e-30], dtype=torch.float32)
    out = exact.index_sum(2, torch.tensor([0, 0, 1]), tiny)
    np.testing.assert_allclose(out.numpy(), [4e-30, -1e-30], rtol=1e-6)
    x = torch.tensor([1.0, 1e-8, -1.0], dtype=torch.float32)   # cancels exactly
    assert exact.index_sum(1, torch.zeros(3, dtype=torch.int64), x)[0] == np.float32(1e-8)


def test_sums_keep_their_bits_across_chunks(monkeypatch):
    """index_sum and scatter_sum convert CHUNK terms at a time; the integer
    sums are exact, so any chunk size gives the same bits."""
    rng = np.random.default_rng(3)
    src, idx = torch.from_numpy(_terms(rng, 3000, (3,))), torch.from_numpy(rng.integers(0, 50, 3000))
    parts = [(torch.from_numpy(rng.integers(0, 36, (4, 50, 64))),
              torch.from_numpy(_terms(rng, 4, (50, 64)))) for _ in range(2)]
    whole = exact.index_sum(50, idx, src), exact.scatter_sum(36, parts)
    monkeypatch.setattr(exact, "CHUNK", 100)
    chunked = exact.index_sum(50, idx, src), exact.scatter_sum(36, parts)
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


def test_scatter_sum_does_not_depend_on_the_order_of_terms():
    rng = np.random.default_rng(1)
    parts = [(rng.integers(0, 36, (4, 50, 256)), rng.random((4, 50, 256)).astype(np.float32))
             for _ in range(3)]
    tp = [(torch.from_numpy(i), torch.from_numpy(s)) for i, s in parts]
    a = exact.scatter_sum(36, tp)
    perm = torch.from_numpy(rng.permutation(256))
    b = exact.scatter_sum(36, [(i[..., perm], s[..., perm]) for i, s in reversed(tp)])
    assert torch.equal(a, b)
    ref = _float_scatter_sum(36, [(i, s.double()) for i, s in tp]).numpy()
    bound = np.abs(ref) * 2.0 ** -24 + 768 * 2.0 ** -62 * max(np.abs(s).max() for _, s in parts)
    assert (np.abs(a.numpy() - ref) <= bound).all()


def test_vlad_fixed_point_sums_match_float_sums(monkeypatch):
    rng = np.random.default_rng(2)
    desc = np.abs(rng.normal(size=(5, 300, 128))).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    mask = rng.random((5, 300)) > 0.1
    d, m = torch.from_numpy(desc), torch.from_numpy(mask)
    draws = vlad.draw_samples(1500, m.reshape(-1), 16, 1000,
                              torch.Generator().manual_seed(0))
    kw = dict(n_neighbors=2, n_centers=16, sample=1000, draws=draws)
    pi, pj, emb = vlad.vlad_pairs(d, m, **kw)
    monkeypatch.setattr(exact, "index_sum", _float_index_sum)
    pi_f, pj_f, emb_f = vlad.vlad_pairs(d, m, **kw)
    np.testing.assert_array_equal(pi, pi_f)
    np.testing.assert_array_equal(pj, pj_f)
    np.testing.assert_allclose(emb, emb_f, rtol=0, atol=1e-5)


def test_sift_fixed_point_sums_match_float_sums(monkeypatch):
    gray = torch.from_numpy(render_panorama(np.array([0.3, 0.1, 0.2]), 96, 192)[0])
    uv, desc, val, _ = sift_device.detect_and_describe(gray, num_features=512)
    monkeypatch.setattr(exact, "scatter_sum", _float_scatter_sum)
    uv_f, desc_f, val_f, _ = sift_device.detect_and_describe(gray, num_features=512)
    assert int(val.sum()) > 100
    assert torch.equal(uv, uv_f) and torch.equal(val, val_f)
    err = (desc - desc_f).abs().amax(dim=-1)[val]
    assert (err < 1e-5).float().mean() >= 0.99, err.max()
