"""VLAD image retrieval for loop-closure pair proposal — the port of
panovlm_tpu/models/vlad.py (VLADMatcher of the reference, sfm/VLAD.{h,cpp}):
a k-means codebook over sampled descriptors, one VLAD embedding per frame
(residual sums per centre, intra-normalised, power-normalised, L2), cosine
KNN over frames.

The JAX module draws its descriptor sample and its initial centres with
`jax.random.choice`. Here both draws are an argument (`draws`), so a test
can inject jax.random's; without it they come from a `torch.Generator` on
the descriptors' device (ROADMAP F5: the two generators give different
numbers from one seed).

The residual and centre sums go through `ops/exact.index_sum` (exact int64
fixed-point sums), so the codebook, the embeddings and the pair set are the same
on every run: float atomics on the card are not (ROADMAP F8).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import exact


def _sq_dist(x, centers):
    return (torch.sum(x * x, -1)[..., None] + torch.sum(centers * centers, 1)
            - 2.0 * torch.matmul(x, centers.T))


def kmeans(desc, mask, init_idx, iters: int = 15):
    """Lloyd k-means over masked descriptors desc (N, D), mask (N,) float,
    from the centres desc[init_idx]. Returns (C, D)."""
    centers = desc[init_idx]
    w = mask.to(desc.dtype)
    for _ in range(iters):
        d2 = torch.where(mask[:, None] != 0, _sq_dist(desc, centers),
                         torch.full((), float("inf"), device=desc.device))
        assign = torch.argmin(d2, dim=1)
        sums = exact.index_sum(centers.shape[0], assign, desc * w[:, None])
        cnts = exact.index_sum(centers.shape[0], assign, w)
        new = sums / torch.clamp_min(cnts, 1.0)[:, None]
        centers = torch.where((cnts > 0)[:, None], new, centers)
    return centers


def vlad_embedding(desc, mask, centers):
    """VLAD vectors of a batch of frames: desc (N, F, D), mask (N, F) float,
    centers (K, D) -> (N, K*D)."""
    N, F, D = desc.shape
    K = centers.shape[0]
    assign = torch.argmin(_sq_dist(desc, centers), dim=-1)          # (N, F)
    resid = (desc - centers[assign]) * mask[..., None]
    flat = (assign + K * torch.arange(N, device=desc.device)[:, None]).reshape(-1)
    v = exact.index_sum(N * K, flat, resid.reshape(-1, D)).reshape(N, K, D)
    v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
    v = v.reshape(N, K * D)
    v = torch.sign(v) * torch.sqrt(torch.abs(v))
    return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)


def draw_samples(n_total: int, fmask_flat, n_centers: int, sample: int,
                 generator: torch.Generator):
    """The two draws of vlad_pairs: the descriptor sample (None when all
    descriptors are kept) and the initial centres, among valid
    descriptors of the sample, without replacement."""
    dev = fmask_flat.device
    sel = None
    if n_total > sample:
        sel = torch.randperm(n_total, generator=generator, device=dev)[:sample]
        fmask_flat = fmask_flat[sel]
    p = fmask_flat.to(torch.float32)
    init = torch.multinomial(p / torch.clamp_min(p.sum(), 1.0), n_centers,
                             replacement=False, generator=generator)
    return sel, init


def vlad_pairs(descs, fmasks, n_neighbors: int = 10, n_centers: int = 128,
               sample: int = 20000, draws=None, seed: int = 0):
    """GenerateCodeBook + ComputeVLADEmbedding + FindNeighbors. descs
    (N, F, D) float32, fmasks (N, F) bool, on one device. draws: optional
    (sample indices or None, initial centre indices) as `draw_samples`
    returns them. Returns (pi, pj, embeddings (N, K*D) numpy)."""
    N, F, D = descs.shape
    flat = descs.reshape(-1, D)
    fmask = fmasks.reshape(-1)
    if draws is None:
        gen = torch.Generator(device=descs.device).manual_seed(seed)
        draws = draw_samples(flat.shape[0], fmask, n_centers, sample, gen)
    sel, init = draws
    if flat.shape[0] > sample:
        flat, fmask = flat[sel], fmask[sel]
    centers = kmeans(flat, fmask.to(flat.dtype), init)
    emb = vlad_embedding(descs, fmasks.to(descs.dtype), centers)
    sim = (emb @ emb.T).cpu().numpy()
    np.fill_diagonal(sim, -np.inf)
    pairs = set()
    for i in range(N):
        for j in np.argsort(-sim[i])[:n_neighbors]:
            pairs.add((min(i, int(j)), max(i, int(j))))
    ordered = sorted(pairs)
    return (np.array([p[0] for p in ordered], np.int32),
            np.array([p[1] for p in ordered], np.int32), emb.cpu().numpy())
