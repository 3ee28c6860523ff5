"""SIFT descriptor matching — the port of `_match_descriptors` of
panovlm_tpu/utils/sift.py (MatchSIFT and the pair filter of the reference,
sfm/SfM.cpp:229-295), batched over pairs.

The nearest-neighbour search goes through `ops/knn.knn_mutual`: on the
card one launch of the descriptor KNN kernel (`csrc/knn_desc.cu`) per batch
of pairs gives the top-2 forward and the top-1 reverse search; on the CPU
its plain version (two `knn_reference` calls). The JAX package's default path forms
2 - 2 d1.d2 with an einsum; the kernel forms |d1|^2 + |d2|^2 - 2 d1.d2. For
unit-norm (RootSIFT) descriptors the two differ only by rounding.

The host cv2 detector of the JAX module (`extract_sift`) is not ported:
the machine with the card has no cv2. The port's detector is
`ops/sift_device.py`.
"""

from __future__ import annotations

import torch

from ..ops import knn as knn_ops

BIG = 1e9


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
