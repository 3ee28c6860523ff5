"""Batched masked KNN — wrappers of the CUDA kernels in `csrc/knn.cu` and
`csrc/knn_desc.cu`, and their plain PyTorch versions.

`knn` replaces `panovlm_tpu/ops/pallas/knn.py:_knn_kernel` (driven by
`knn_pallas_batched`) and `knn_ring` replaces `_knn_ring_kernel` (driven by
`knn_ring_pallas_batched`). `knn` dispatches on the feature dimension D:
`csrc/knn.cu` for the point clouds (D <= 4, any k <= 16), `csrc/knn_desc.cu`
for descriptors (4 < D <= 128, D a multiple of 4, k <= 2: SIFT matching at
D = 128). `knn_mutual` is the matcher's pair of searches in one launch of
the descriptor kernel: the forward top-2 and the reverse top-1, from one
pass over the (Q, T) distances (3xTF32 tensor-core products, fp32
accuracy). On a CUDA tensor a wrapper launches its kernel or raises; on a
CPU tensor it calls the plain version. Each kernel's launches are counted
in a plain integer (`knn.launches` for D <= 4, `knn.desc_launches` for the
descriptor kernel called through `knn`, `knn_mutual.launches`,
`knn_ring.launches`).

Semantics shared by kernels and plain versions: d2 = |q|^2 + |t|^2 - 2 q.t
in float32, clamped at 0; masked query rows and masked targets give
d2 = 1e30. The k smallest d2 come in ascending order with ties to the lower
target index; a slot that no valid target fills holds d2 = 1e30 and index 0.
"""

from __future__ import annotations

import struct

import torch

from . import _build

BIG = 1e30
MAX_D = 4          # csrc/knn.cu; wider features go to csrc/knn_desc.cu
MAX_D_DESC = 128   # csrc/knn_desc.cu kDmax
MAX_K = 16
MAX_K_DESC = 2
# reverse-search key of an empty slot: float bits of 1e30 << 32 | index 0
KEY_EMPTY = struct.unpack("<I", struct.pack("<f", BIG))[0] << 32
RING_OFFSETS = (-2, -1, 1, 2)


def _check(q, q_mask, t, t_mask, k):
    if q.dim() != 3 or t.dim() != 3:
        raise ValueError(f"q and t must be (B, Q, D) and (B, T, D), got "
                         f"{tuple(q.shape)} and {tuple(t.shape)}")
    B, Q, D = q.shape
    if t.shape[0] != B or t.shape[2] != D:
        raise ValueError(f"t {tuple(t.shape)} does not match q {tuple(q.shape)}")
    if D > MAX_D and (D % 4 or D > MAX_D_DESC):
        raise ValueError(f"feature dim D={D}: the kernels take D <= {MAX_D} "
                         f"or a multiple of 4 up to {MAX_D_DESC}")
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


def _launch_desc(q, q_mask, t, t_mask, k, reverse: bool):
    """One launch of csrc/knn_desc.cu: the forward top-k (d2, idx) and,
    with `reverse`, the reverse top-1 keys (B, T) int64."""
    lib = _build.load()
    B, Q, D = q.shape
    T = t.shape[1]
    dev = q.device
    if q.data_ptr() % 16 or t.data_ptr() % 16:
        raise ValueError("the descriptor kernel takes 16-byte aligned q and t")
    out_d = torch.empty((B, Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, Q, k), dtype=torch.int32, device=dev)
    norms = torch.empty(B * (Q + T), dtype=torch.float32, device=dev)
    keys = torch.full((B, T), KEY_EMPTY, dtype=torch.int64, device=dev) if reverse else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.knn_desc_launch(q.data_ptr(), q_mask.data_ptr(), t.data_ptr(),
                                 t_mask.data_ptr(), B, Q, T, D, k, int(reverse),
                                 norms.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
                                 None if keys is None else keys.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"knn_desc kernel launch failed: cudaError {rc}")
    return out_d, out_i, keys


def _decode_keys(keys):
    """(B, T) int64 reverse keys -> (d2 (B,T,1) float32, idx (B,T,1) int32)."""
    d = (keys >> 32).to(torch.int32).view(torch.float32)
    i = (keys & 0xFFFFFFFF).to(torch.int32)
    return d[..., None], i[..., None]


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
        d, i, _ = _launch_desc(q, q_mask, t, t_mask, k, reverse=False)
        knn.desc_launches += 1
        return d, i
    d, i, _, _ = _launch(q, q_mask, t, t_mask, None, None, k, None)
    knn.launches += 1
    return d, i


def knn_mutual_reference(d1, m1, d2, m2):
    """Plain PyTorch version of `knn_mutual`: two `knn_reference` calls."""
    fd, fi = knn_reference(d1, m1, d2, m2, 2)
    rd, ri = knn_reference(d2, m2, d1, m1, 1)
    return fd, fi, rd, ri


def knn_mutual(d1, m1, d2, m2):
    """The two searches of mutual matching: knn(d1, m1, d2, m2, 2) and
    knn(d2, m2, d1, m1, 1), in one launch of the descriptor kernel on the
    card. d1 (B,N1,D), d2 (B,N2,D) float32 with 4 < D <= 128, masks bool.
    Returns (d2 (B,N1,2), idx (B,N1,2), reverse d2 (B,N2,1), reverse idx
    (B,N2,1)); the reverse search ties to the lower index of d1 and
    leaves 1e30 / 0 where no valid row of d1 exists."""
    dev = _check(d1, m1, d2, m2, 2)
    _check(d2, m2, d1, m1, 1)
    if d1.shape[2] <= MAX_D:
        raise ValueError(f"knn_mutual takes descriptors (D > {MAX_D}), got D={d1.shape[2]}")
    if dev.type == "cpu":
        return knn_mutual_reference(d1, m1, d2, m2)
    fd, fi, keys = _launch_desc(d1, m1, d2, m2, 2, reverse=True)
    knn_mutual.launches += 1
    return (fd, fi, *_decode_keys(keys))


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
knn_mutual.launches = 0
knn_ring.launches = 0
