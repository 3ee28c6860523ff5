"""CUDA KNN kernels (panovlm_tpu_torch/csrc/knn.cu, and csrc/knn_desc.cu at
the SIFT descriptor width D = 128) against their plain PyTorch versions, on
the card. Marked `cuda`: they skip where
torch.cuda.is_available() is false. This file imports neither jax nor the
test conftest's fixtures, so it runs on a machine without JAX:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_knn_cuda.py

Tolerance: d2 within rtol 1e-5 and atol 1e-5 (FMA order in the kernel,
matmul order in the plain version); indices equal except on near-ties,
where two distances of a row differ by <= 1e-5 * max(1, d2). The fused
descriptor search (knn_mutual) is held against two plain searches by the
same rule, and two launches on the same inputs must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from panovlm_tpu_torch.ops import knn as tknn

B, Q, T = 2, 300, 700


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Q, 3)).astype(np.float32)
    t = rng.normal(size=(B, T, 3)).astype(np.float32)
    qm = rng.random((B, Q)) > 0.1
    tm = rng.random((B, T)) > 0.1
    qr = rng.integers(0, 16, (B, Q)).astype(np.int32)
    tr = rng.integers(0, 16, (B, T)).astype(np.int32)
    return q, qm, t, tm, qr, tr


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is false)")
    from panovlm_tpu_torch.device import resolve
    return resolve("cuda")


def _near_tie_mask(d_ref_k1, k):
    """Slots of the first k whose d2 lies within 1e-5 * max(1, d2) of a
    neighbouring slot (d_ref_k1 holds k + 1 sorted slots)."""
    d = d_ref_k1.double()
    close = (d[..., 1:] - d[..., :-1]).abs() <= 1e-5 * torch.clamp_min(d[..., 1:], 1.0)
    tie = torch.zeros_like(d, dtype=torch.bool)
    tie[..., 1:] |= close
    tie[..., :-1] |= close
    return tie[..., :k]


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 10, 16])
def test_knn_kernel_matches_plain_version(cuda_device, k):
    q, qm, t, tm, _, _ = (torch.from_numpy(a).to(cuda_device) for a in _inputs(k))
    n0 = tknn.knn.launches
    d, i = tknn.knn(q, qm, t, tm, k)
    assert tknn.knn.launches == n0 + 1
    d_ref, i_ref = tknn.knn_reference(q, qm, t, tm, k)
    d_k1, _ = tknn.knn_reference(q, qm, t, tm, k + 1)
    torch.cuda.synchronize()
    torch.testing.assert_close(d, d_ref, rtol=1e-5, atol=1e-5)
    ok = ~_near_tie_mask(d_k1, k)
    assert torch.equal(i[ok], i_ref[ok])
    assert (d[~qm] >= 1e29).all() and (i[~qm] == 0).all()


@pytest.mark.cuda
def test_knn_ring_kernel_matches_plain_version(cuda_device):
    q, qm, t, tm, qr, tr = (torch.from_numpy(a).to(cuda_device) for a in _inputs(3))
    n0 = tknn.knn_ring.launches
    d, i, rd, ri = tknn.knn_ring(q, qm, t, tm, qr, tr, 10)
    assert tknn.knn_ring.launches == n0 + 1
    d_ref, i_ref, rd_ref, ri_ref = tknn.knn_ring_reference(q, qm, t, tm, qr, tr, 10)
    d_k1, _ = tknn.knn_reference(q, qm, t, tm, 11)
    torch.cuda.synchronize()
    torch.testing.assert_close(d, d_ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rd, rd_ref, rtol=1e-5, atol=1e-5)
    ok = ~_near_tie_mask(d_k1, 10)
    assert torch.equal(i[ok], i_ref[ok])
    # a ring index may differ only where its distance ties the plain pick
    d2 = tknn._dist2(q, qm, t, tm)
    picked = torch.gather(d2, -1, ri.long())
    have = rd_ref < 1e29
    assert ((picked - rd_ref).abs() <= 1e-5 * torch.clamp_min(rd_ref, 1.0))[have].all()
    assert (ri[~have] == 0).all() and (rd[~have] >= 1e29).all()


@pytest.mark.cuda
def test_kernel_rejects_cpu_cuda_mix(cuda_device):
    q, qm, t, tm, _, _ = (torch.from_numpy(a) for a in _inputs(1))
    with pytest.raises(ValueError):
        tknn.knn(q.to(cuda_device), qm, t, tm, 5)


def _descriptors(seed, B, Q, T, D=128):
    """Unit-norm non-negative descriptors (RootSIFT-like), with near
    duplicates so that the top-2 lists hold close distances."""
    rng = np.random.default_rng(seed)
    t = np.abs(rng.normal(size=(B, T, D))).astype(np.float32)
    q = t[:, rng.integers(0, T, Q)] + 0.3 * np.abs(rng.normal(size=(B, Q, D)))
    q = q.astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    return q, rng.random((B, Q)) > 0.05, t, rng.random((B, T)) > 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("k, shape", [(1, (3, 500, 700)), (2, (3, 500, 700)),
                                      (2, (2, 8096, 8096))])
def test_knn_descriptor_kernel_matches_plain_version(cuda_device, k, shape):
    B, Qn, Tn = shape
    q, qm, t, tm = (torch.from_numpy(a).to(cuda_device)
                    for a in _descriptors(k + Qn, B, Qn, Tn))
    n0, n1 = tknn.knn.desc_launches, tknn.knn.launches
    d, i = tknn.knn(q, qm, t, tm, k)
    assert (tknn.knn.desc_launches, tknn.knn.launches) == (n0 + 1, n1)
    for b in range(B):       # the plain version one batch element at a time
        sl = slice(b, b + 1)
        d_ref, i_ref = tknn.knn_reference(q[sl], qm[sl], t[sl], tm[sl], k)
        d_k1, _ = tknn.knn_reference(q[sl], qm[sl], t[sl], tm[sl], k + 1)
        torch.cuda.synchronize()
        torch.testing.assert_close(d[sl], d_ref, rtol=1e-5, atol=1e-5)
        ok = ~_near_tie_mask(d_k1, k)
        assert torch.equal(i[sl][ok], i_ref[ok])
    assert (d[~qm] >= 1e29).all() and (i[~qm] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 517, 1203, 128), (2, 300, 130, 64), (2, 8096, 8096, 128)])
def test_knn_mutual_matches_two_plain_searches(cuda_device, shape):
    """Forward top-2 and reverse top-1 from one launch; Q and T not
    multiples of the 128 x 64 tile, masked rows on both sides."""
    B, Qn, Tn, D = shape
    q, qm, t, tm = (torch.from_numpy(a).to(cuda_device)
                    for a in _descriptors(Qn + Tn, B, Qn, Tn, D))
    n0, n1 = tknn.knn_mutual.launches, tknn.knn.desc_launches
    out = tknn.knn_mutual(q, qm, t, tm)
    again = tknn.knn_mutual(q, qm, t, tm)
    assert (tknn.knn_mutual.launches, tknn.knn.desc_launches) == (n0 + 2, n1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    fd, fi, rd, ri = out
    for b in range(B):
        sl = slice(b, b + 1)
        for (d, i), (x, xm, y, ym), k in (((fd, fi), (q, qm, t, tm), 2),
                                          ((rd, ri), (t, tm, q, qm), 1)):
            d_ref, i_ref = tknn.knn_reference(x[sl], xm[sl], y[sl], ym[sl], k)
            d_k1, _ = tknn.knn_reference(x[sl], xm[sl], y[sl], ym[sl], k + 1)
            torch.testing.assert_close(d[sl], d_ref, rtol=1e-5, atol=1e-5)
            ok = ~_near_tie_mask(d_k1, k)
            assert torch.equal(i[sl][ok], i_ref[ok])
    assert (fd[~qm] >= 1e29).all() and (fi[~qm] == 0).all()
    assert (rd[~tm] >= 1e29).all() and (ri[~tm] == 0).all()
