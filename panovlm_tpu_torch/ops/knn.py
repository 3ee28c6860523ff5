"""Batched masked KNN — wrappers of the CUDA kernels in `csrc/knn.cu`, and
their plain PyTorch versions.

`knn` replaces `panovlm_tpu/ops/pallas/knn.py:_knn_kernel` (driven by
`knn_pallas_batched`) and `knn_ring` replaces `_knn_ring_kernel` (driven by
`knn_ring_pallas_batched`). `knn` dispatches on the feature dimension D:
`csrc/knn.cu` for the point clouds (D <= 4, any k <= 16), `csrc/knn_desc.cu`
for descriptors (4 < D, D a multiple of 4, k <= 2: SIFT matching at
D = 128). On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor it calls the plain version. Each kernel's launches are counted in a
plain integer (`knn.launches` for D <= 4, `knn.desc_launches` for the
descriptor kernel, `knn_ring.launches`).

Semantics shared by kernel and plain version: d2 = |q|^2 + |t|^2 - 2 q.t in
float32, clamped at 0; masked query rows and masked targets give d2 = 1e30.
The k smallest d2 come in ascending order with ties to the lower target
index; a slot that no valid target fills holds d2 = 1e30 and index 0.
"""

from __future__ import annotations

import torch

from . import _build

BIG = 1e30
MAX_D = 4          # csrc/knn.cu; wider features go to csrc/knn_desc.cu
MAX_K = 16
MAX_K_DESC = 2
RING_OFFSETS = (-2, -1, 1, 2)


def _check(q, q_mask, t, t_mask, k):
    if q.dim() != 3 or t.dim() != 3:
        raise ValueError(f"q and t must be (B, Q, D) and (B, T, D), got "
                         f"{tuple(q.shape)} and {tuple(t.shape)}")
    B, Q, D = q.shape
    if t.shape[0] != B or t.shape[2] != D:
        raise ValueError(f"t {tuple(t.shape)} does not match q {tuple(q.shape)}")
    if D > MAX_D and D % 4:
        raise ValueError(f"feature dim D={D}: the kernels take D <= {MAX_D} "
                         "or a multiple of 4")
    max_k = MAX_K if D <= MAX_D else MAX_K_DESC
    if not 1 <= k <= min(max_k, t.shape[1]):
        raise ValueError(f"k={k}: the kernel for D={D} takes 1 <= k <= min({max_k}, T)")
    if B > 65535:
        raise ValueError(f"batch {B} exceeds the kernel's grid limit 65535")
    if q.dtype != torch.float32 or t.dtype != torch.float32:
        raise TypeError(f"q and t must be float32, got {q.dtype}, {t.dtype}")
    if q_mask.shape != (B, Q) or t_mask.shape != (B, t.shape[1]):
        raise ValueError("masks must be (B, Q) and (B, T)")
    if q_mask.dtype != torch.bool or t_mask.dtype != torch.bool:
        raise TypeError("masks must be bool")
    tensors = (q, q_mask, t, t_mask)
    devices = {x.device for x in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on several devices: {devices}")
    dev = q.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and not all(x.is_contiguous() for x in tensors):
        raise ValueError("the kernel takes contiguous tensors only")
    return dev


def _check_rows(q, t, q_row, t_row, drs):
    if len(drs) != len(RING_OFFSETS):
        raise ValueError(f"the ring kernel takes exactly 4 ring offsets, got {drs}")
    if q_row.shape != q.shape[:2] or t_row.shape != t.shape[:2]:
        raise ValueError("ring ids must be (B, Q) and (B, T)")
    if q_row.dtype != torch.int32 or t_row.dtype != torch.int32:
        raise TypeError("ring ids must be int32")
    if q_row.device != q.device or t_row.device != q.device:
        raise ValueError("ring ids must lie on the device of q")
    if q.device.type == "cuda" and not (q_row.is_contiguous() and t_row.is_contiguous()):
        raise ValueError("the kernel takes contiguous tensors only")


def _dist2(q, q_mask, t, t_mask):
    """The expanded, masked (B, Q, T) squared-distance matrix."""
    d2 = (torch.sum(q * q, dim=-1)[..., :, None]
          + torch.sum(t * t, dim=-1)[..., None, :]
          - 2.0 * torch.matmul(q, t.transpose(-1, -2)))
    d2 = torch.clamp_min(d2, 0.0)
    valid = q_mask[..., :, None] & t_mask[..., None, :]
    return torch.where(valid, d2, torch.full_like(d2, BIG))


def _topk_stable(d2, k):
    """First k of a stable ascending sort; unfilled (BIG) slots -> index 0."""
    d, i = torch.sort(d2, dim=-1, stable=True)
    d, i = d[..., :k], i[..., :k]
    i = torch.where(d >= BIG, torch.zeros_like(i), i)
    return d, i.to(torch.int32)


def knn_reference(q, q_mask, t, t_mask, k: int):
    """Plain PyTorch version of `knn` (materializes (B, Q, T))."""
    return _topk_stable(_dist2(q, q_mask, t, t_mask), k)


def knn_ring_reference(q, q_mask, t, t_mask, q_row, t_row, k: int,
                       drs: tuple = RING_OFFSETS):
    """Plain PyTorch version of `knn_ring`: the top-k plus, per ring offset,
    a masked row-min over the targets on ring q_row + dr."""
    d2 = _dist2(q, q_mask, t, t_mask)
    d, i = _topk_stable(d2, k)
    rd, ri = [], []
    for dr in drs:
        same = t_row[..., None, :] == (q_row[..., :, None] + dr)
        d2r = torch.where(same, d2, torch.full_like(d2, BIG))
        vmin, amin = torch.min(d2r, dim=-1)   # first occurrence on ties
        rd.append(vmin)
        ri.append(torch.where(vmin < BIG, amin, torch.zeros_like(amin)))
    return d, i, torch.stack(rd, dim=-1), torch.stack(ri, dim=-1).to(torch.int32)


def _launch_desc(q, q_mask, t, t_mask, k):
    lib = _build.load()
    B, Q, D = q.shape
    dev = q.device
    out_d = torch.empty((B, Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, Q, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn_desc_launch(q.data_ptr(), q_mask.data_ptr(), t.data_ptr(),
                                 t_mask.data_ptr(), B, Q, t.shape[1], D, k,
                                 out_d.data_ptr(), out_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"knn_desc kernel launch failed: cudaError {rc}")
    return out_d, out_i


def _launch(q, q_mask, t, t_mask, q_row, t_row, k, drs):
    lib = _build.load()
    B, Q, D = q.shape
    T = t.shape[1]
    dev = q.device
    out_d = torch.empty((B, Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, Q, k), dtype=torch.int32, device=dev)
    ring = q_row is not None
    if ring:
        ring_d = torch.empty((B, Q, len(drs)), dtype=torch.float32, device=dev)
        ring_i = torch.empty((B, Q, len(drs)), dtype=torch.int32, device=dev)
    else:
        ring_d = ring_i = None
        drs = (0, 0, 0, 0)

    def ptr(x):
        return None if x is None else x.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn_launch(ptr(q), ptr(q_mask), ptr(t), ptr(t_mask),
                            ptr(q_row), ptr(t_row), B, Q, T, D, k, int(ring),
                            *[int(x) for x in drs], ptr(out_d), ptr(out_i),
                            ptr(ring_d), ptr(ring_i), stream)
    if rc != 0:
        raise RuntimeError(f"knn kernel launch failed: cudaError {rc}")
    return out_d, out_i, ring_d, ring_i


def knn(q, q_mask, t, t_mask, k: int):
    """Masked k-nearest neighbours. q (B,Q,D), t (B,T,D) float32, masks bool.
    Returns (d2 (B,Q,k) float32, idx (B,Q,k) int32)."""
    dev = _check(q, q_mask, t, t_mask, k)
    if dev.type == "cpu":
        return knn_reference(q, q_mask, t, t_mask, k)
    if q.shape[2] > MAX_D:
        out = _launch_desc(q, q_mask, t, t_mask, k)
        knn.desc_launches += 1
        return out
    d, i, _, _ = _launch(q, q_mask, t, t_mask, None, None, k, None)
    knn.launches += 1
    return d, i


def knn_ring(q, q_mask, t, t_mask, q_row, t_row, k: int,
             drs: tuple = RING_OFFSETS):
    """`knn` plus, for each of the four ring offsets dr, the nearest target
    whose ring id equals q_row + dr. q_row (B,Q), t_row (B,T) int32. Returns
    (d2, idx, ring_d2 (B,Q,4), ring_idx (B,Q,4))."""
    dev = _check(q, q_mask, t, t_mask, k)
    if q.shape[2] > MAX_D:
        raise ValueError(f"the ring kernel takes D <= {MAX_D}, got {q.shape[2]}")
    _check_rows(q, t, q_row, t_row, drs)
    if dev.type == "cpu":
        return knn_ring_reference(q, q_mask, t, t_mask, q_row, t_row, k, drs)
    out = _launch(q, q_mask, t, t_mask, q_row, t_row, k, drs)
    knn_ring.launches += 1
    return out


knn.launches = 0
knn.desc_launches = 0
knn_ring.launches = 0
