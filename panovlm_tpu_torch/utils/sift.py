"""SIFT extraction on the host and descriptor matching — the port of
panovlm_tpu/utils/sift.py.

`extract_sift` / `extract_sift_batch` are the JAX module's host detector:
cv2's SIFT (here `native/sift.cpp`, which gives cv2's bits), then the same
grid distribution and RootSIFT in numpy, in the same operations and order.
The frames run on the native library's threads (`pool_workers` of
`num_threads`, at most the cores, fewer where the host's memory is short),
where the JAX package runs a process pool. The on-device detector of the
config key `sift_device` is `ops/sift_device.py`.

`match_descriptors` ports `_match_descriptors` (MatchSIFT and the pair
filter of the reference, sfm/SfM.cpp:229-295), batched over pairs. The
nearest-neighbour search goes through `ops/knn.knn_mutual`: on the card one
launch of the descriptor KNN kernel (`csrc/knn_desc.cu`) per batch of pairs
gives the top-2 forward and the top-1 reverse search; on the CPU its plain
version (two `knn_reference` calls). The JAX package's default path forms
2 - 2 d1.d2 with an einsum; the kernel forms |d1|^2 + |d2|^2 - 2 d1.d2. For
unit-norm (RootSIFT) descriptors the two differ only by rounding.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import knn as knn_ops

BIG = 1e9


def pool_workers(num_threads: int = -1) -> int:
    """Config num_threads (<= 0: all cores) capped to the host's cores."""
    cpus = os.cpu_count() or 1
    if num_threads is None or num_threads <= 0:
        return cpus
    return max(1, min(int(num_threads), cpus))


def _features(kp, desc, shape, num_features, root_sift, grid_distribute, grid):
    """The JAX module's steps after cv2: the grid distribution, RootSIFT and
    the L2 norm, in the same numpy operations."""
    if len(kp) == 0:
        return (np.zeros((0, 2), np.float32), np.zeros((0, 128), np.float32),
                np.zeros((0,), np.float32))
    uv = np.ascontiguousarray(kp[:, :2])
    resp = np.ascontiguousarray(kp[:, 4])
    desc = desc.astype(np.float32)
    if grid_distribute and len(kp) > num_features:
        # spatial distribution: strongest responses per grid cell first
        h, w = shape
        gy, gx = grid
        cell = (np.minimum(uv[:, 1] * gy / h, gy - 1).astype(int) * gx
                + np.minimum(uv[:, 0] * gx / w, gx - 1).astype(int))
        order = np.lexsort((-resp, cell))
        cell_sorted = cell[order]
        rank_in_cell = np.zeros(len(order), int)
        counts: dict[int, int] = {}
        for pos, c in enumerate(cell_sorted):
            rank_in_cell[pos] = counts.get(c, 0)
            counts[c] = rank_in_cell[pos] + 1
        # round-robin by in-cell rank: every cell's strongest first
        sel = order[np.argsort(rank_in_cell, kind="stable")][:num_features]
        uv, desc, resp = uv[sel], desc[sel], resp[sel]
    if root_sift:
        # RootSIFT: L1 normalize then sqrt (Arandjelovic & Zisserman CVPR'12)
        desc = desc / (np.abs(desc).sum(axis=1, keepdims=True) + 1e-12)
        desc = np.sqrt(desc)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True) + 1e-12
    return uv, desc, resp


def extract_sift(gray: np.ndarray, num_features: int = 8096,
                 root_sift: bool = True, mask: np.ndarray | None = None,
                 grid_distribute: bool = True, grid: tuple = (16, 32)):
    """SIFT keypoints and descriptors of one uint8 gray image, as the JAX
    module's extract_sift gives them: cv2's detector asked for 2 x
    num_features (num_features without the grid distribution), then at most
    num_features spread over a gy x gx grid, RootSIFT and L2-normalised.

    Returns (uv (F, 2) float32 pixel coords, desc (F, 128) float32,
    response (F,)), F <= num_features."""
    from ..native import sift as native_sift
    nf = num_features * 2 if grid_distribute else num_features
    (kp, _, desc), = native_sift.detect_and_compute(gray, mask, nf)
    return _features(kp, desc, gray.shape[:2], num_features, root_sift, grid_distribute, grid)


def extract_sift_batch(grays_u8, cap: int, root_sift: bool = True,
                       mask: np.ndarray | None = None,
                       num_threads: int = -1, force_workers: int = 0):
    """extract_sift over a frame stack, padded to `cap`: the frames run on
    pool_workers(num_threads) native threads (`force_workers` overrides
    that count), fewer when a quarter of the host's memory does not hold
    that many frames in flight. Returns (uv (N, cap, 2), desc (N, cap, 128),
    fmask (N, cap)) numpy."""
    from ..native import sift as native_sift
    from .membudget import host_total_bytes
    frames = np.ascontiguousarray(np.stack([np.asarray(g, np.uint8) for g in grays_u8]))
    n, h, w = frames.shape
    threads = force_workers or pool_workers(num_threads)
    threads = min(threads, max(1, host_total_bytes() // 4 // native_sift.frame_bytes(h, w)))
    outs = native_sift.detect_and_compute(frames, mask, cap * 2, threads)
    padded = [pad_features(*_features(kp, d, (h, w), cap, root_sift, True, (16, 32))[:2], cap)
              for kp, _, d in outs]
    return (np.stack([p[0] for p in padded]), np.stack([p[1] for p in padded]),
            np.stack([p[2] for p in padded]))


def pad_features(uv, desc, cap: int):
    F = min(len(uv), cap)
    uv_p = np.zeros((cap, 2), np.float32)
    d_p = np.zeros((cap, 128), np.float32)
    m = np.zeros((cap,), bool)
    uv_p[:F] = uv[:F]
    d_p[:F] = desc[:F]
    m[:F] = True
    return uv_p, d_p, m


def match_descriptors(d1, m1, d2, m2, ratio: float = 0.6,
                      max_dist_factor: float = 0.8, max_matches: int = 1024):
    """Brute-force matching of a batch of image pairs: top-2 ratio test on
    squared distances (ratio^2), mutual best through a reverse top-1 search,
    then the matches farther than max_dist_factor x the largest accepted
    distance are dropped, and the rest sorted by distance (stable).

    d1 (B, N1, D), d2 (B, N2, D) float32 L2-normalised, masks (B, N1),
    (B, N2) bool. Returns dict idx (B, K, 2) int32 (feature in image 1,
    feature in image 2), mask (B, K), dist (B, K) with K = min(max_matches,
    N1); rows past the accepted matches are zero."""
    d2_12, idx12, _, idx21 = knn_ops.knn_mutual(d1, m1, d2, m2)
    best = torch.clamp_max(d2_12[..., 0], BIG)
    second = torch.clamp_max(d2_12[..., 1], BIG)
    j1 = idx12[..., 0].long()
    rows = torch.arange(d1.shape[1], device=d1.device)
    mutual = torch.gather(idx21[..., 0], 1, j1) == rows
    pass_ratio = best < (ratio ** 2) * second
    ok = pass_ratio & mutual & m1 & (best < BIG)
    dist = torch.sqrt(torch.clamp_min(best, 0.0))
    max_d = torch.amax(torch.where(ok, dist, torch.zeros_like(dist)), dim=1)
    ok = ok & (dist <= max_dist_factor * torch.clamp_min(max_d, 1e-9)[:, None])
    order = torch.argsort(torch.where(ok, dist, torch.full_like(dist, BIG)),
                          dim=1, stable=True)
    take = order[:, :max_matches]
    out_mask = torch.gather(ok, 1, take)
    pairs = torch.stack([take, torch.gather(j1, 1, take)], dim=-1).to(torch.int32)
    return {"idx": torch.where(out_mask[..., None], pairs, torch.zeros_like(pairs)),
            "mask": out_mask,
            "dist": torch.where(out_mask, torch.gather(dist, 1, take),
                                torch.zeros_like(out_mask, dtype=dist.dtype))}
