"""Seeded SfM inputs shared by the port's CPU parity tests and its CUDA
tests (numpy only, so that the machine with the card, which has no jax,
imports it too)."""

import numpy as np
from scipy.spatial.transform import Rotation as ScR


def translation_graph(seed=0, n=10, noise=1e-3, window=4):
    """tests/test_sfm_core.py::_translation_graph: cameras with random
    rotations and centres, pairs (i, j < i + window), unit directions with
    `noise`. Returns (aa, C, pi, pj, rel_aa, unit directions, scales)."""
    rng = np.random.default_rng(seed)
    aa = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    aa[0] = 0
    R = ScR.from_rotvec(aa).as_matrix()
    C = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    C[0] = 0
    t = -np.einsum("nij,nj->ni", R, C)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, min(i + window, n))]
    pi = np.array([p[0] for p in pairs], np.int32)
    pj = np.array([p[1] for p in pairs], np.int32)
    rel_aa = np.stack([ScR.from_matrix(R[j] @ R[i].T).as_rotvec()
                       for i, j in pairs]).astype(np.float32)
    t_rel = np.stack([t[j] - (R[j] @ R[i].T) @ t[i] for i, j in pairs])
    scale = np.linalg.norm(t_rel, axis=1)
    u = t_rel / scale[:, None] + rng.normal(size=t_rel.shape) * noise
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    return aa, C, pi, pj, rel_aa, u.astype(np.float32), scale.astype(np.float32)


def planted_features(rng, n=6, cap=64):
    """tests/test_pair_surgery.py::_features: n frames of a shared
    dictionary of cap unit descriptors plus noise, so that the ratio test
    finds the planted matches. Returns (uv, desc, fmask)."""
    base = rng.normal(size=(cap, 128)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    desc = np.stack([base + 0.02 * rng.normal(size=base.shape).astype(np.float32)
                     for _ in range(n)])
    desc /= np.linalg.norm(desc, axis=2, keepdims=True)
    uv = rng.uniform(0, 256, (n, cap, 2)).astype(np.float32)
    return uv, desc, np.ones((n, cap), bool)
