"""Global rotation averaging — the port of panovlm_tpu/models/rotation_averaging.py
(sfm/RotationAveraging.{h,cpp} of the reference): maximum-spanning-tree
initialization, X84 pair filter, the exact L1 refinement (L1-ADMM then
IRLS, solver/l1_admm.py) and the Huber L2 solve; or, for method 2, the
spectral least-squares init and one Huber L2 solve.

The spanning tree is built with the port's own graph code (utils/graph.py),
which keeps networkx's edge and neighbour orders, so ties between equal
weights resolve as in the JAX module.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial.transform import Rotation as ScR

from ..solver import residuals
from ..solver.lm import LMOptions, ResidualBlock, solve_lm
from ..utils import graph as graph_mod
from ..utils.tracks import UnionFind


def spanning_tree_init(n_frames, pair_i, pair_j, rel_aa, weights=None):
    """Maximum-spanning-tree rotation initialization. rel_aa (M,3): R_ji of
    pair (i, j). Returns (aa_fw (N,3) float32, valid (N,)); the root (the
    smallest frame of the largest tree) gets identity."""
    g = graph_mod.Graph()
    for v in range(n_frames):
        g.add_node(v)
    if weights is None:
        gap = np.abs(np.asarray(pair_i) - np.asarray(pair_j)).astype(np.float64)
        w = 1.0 / (1.0 + gap)
    else:
        w = np.asarray(weights)
    for k in range(len(pair_i)):
        i, j = int(pair_i[k]), int(pair_j[k])
        if g.has_edge(i, j) and g.adj[i][j]["weight"] >= w[k]:
            continue
        g.add_edge(i, j, weight=float(w[k]), k=k)
    tree = graph_mod.maximum_spanning_tree(g)
    R = np.tile(np.eye(3), (n_frames, 1, 1))
    valid = np.zeros(n_frames, bool)
    comps = sorted(graph_mod.connected_components(tree), key=len, reverse=True)
    if not comps:
        return np.zeros((n_frames, 3)), valid
    root = min(comps[0])
    valid[root] = True
    for a, b in graph_mod.bfs_edges(tree, root):
        k = tree.adj[a][b]["k"]
        i, j = int(pair_i[k]), int(pair_j[k])
        R_ji = ScR.from_rotvec(np.asarray(rel_aa[k])).as_matrix()
        R[b] = R_ji @ R[a] if (b == j and a == i) else R_ji.T @ R[a]
        valid[b] = True
    return ScR.from_matrix(R).as_rotvec().astype(np.float32), valid


def rotation_averaging_least_square(n_frames, pair_i, pair_j, rel_aa, weights=None):
    """RotationAveragingLeastSquare (RotationAveraging.cpp:185-275): the
    three eigenvectors of A^T A with the smallest eigenvalues hold every
    camera's rotation rows; each 3x3 is projected to SO(3), camera
    argmax(valid) fixed to identity. Host numpy."""
    pair_i, pair_j = np.asarray(pair_i), np.asarray(pair_j)
    M = len(pair_i)
    w2 = np.ones(M) if weights is None else np.asarray(weights, np.float64) ** 2
    R_ji = ScR.from_rotvec(np.asarray(rel_aa)).as_matrix()
    AtA = np.zeros((3 * n_frames, 3 * n_frames))
    valid = np.zeros(n_frames, bool)
    for k in range(M):
        i, j = int(pair_i[k]), int(pair_j[k])
        AtA[3 * i:3 * i + 3, 3 * i:3 * i + 3] += w2[k] * np.eye(3)
        AtA[3 * j:3 * j + 3, 3 * j:3 * j + 3] += w2[k] * np.eye(3)
        AtA[3 * i:3 * i + 3, 3 * j:3 * j + 3] -= w2[k] * R_ji[k].T
        AtA[3 * j:3 * j + 3, 3 * i:3 * i + 3] -= w2[k] * R_ji[k]
        valid[i] = valid[j] = True
    _, evecs = np.linalg.eigh(AtA)
    U, _, Vt = np.linalg.svd(evecs[:, :3].reshape(n_frames, 3, 3))
    R = U @ Vt
    R = R * np.sign(np.linalg.det(R))[:, None, None]
    anchor = int(np.argmax(valid)) if valid.any() else 0
    R = R @ R[anchor].T[None]
    R = np.where(valid[:, None, None], R, np.eye(3))
    return ScR.from_matrix(R).as_rotvec().astype(np.float32), valid


def filter_pairs_x84(pair_i, pair_j, rel_aa, aa_global, k_mad: float = 3.5):
    """X84 (MAD) rejection of rotation measurements against the global
    rotations; temporal edges |i-j| <= 3 are always kept. Host numpy."""
    Ri = ScR.from_rotvec(np.asarray(aa_global)[np.asarray(pair_i)]).as_matrix()
    Rj = ScR.from_rotvec(np.asarray(aa_global)[np.asarray(pair_j)]).as_matrix()
    Rji = ScR.from_rotvec(np.asarray(rel_aa)).as_matrix()
    cycle = np.einsum("mij,mkj->mik", np.einsum("mij,mkj->mik", Rj, Ri), Rji)
    err = np.linalg.norm(ScR.from_matrix(cycle).as_rotvec(), axis=1)
    med = np.median(err)
    mad = np.median(np.abs(err - med)) + 1e-12
    keep = err <= med + k_mad * 1.4826 * mad
    return keep | (np.abs(np.asarray(pair_i) - np.asarray(pair_j)) <= 3)


def _solve(aa0, pair_i, pair_j, rel_aa, mask, loss, loss_scale, max_iters,
           fixed_idx: int, device):
    def t(a, dt):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    m = len(np.asarray(pair_i))
    fixed = np.zeros((len(aa0), 3), bool)
    fixed[fixed_idx] = True
    block = ResidualBlock(residuals.pairwise_rotation, ("rot", "rot"),
                          (t(pair_i, torch.int64), t(pair_j, torch.int64)),
                          (t(rel_aa, torch.float32),),
                          torch.ones(m, device=device), t(mask, torch.bool),
                          loss=loss, loss_scale=loss_scale)
    out, info = solve_lm({"rot": t(aa0, torch.float32)}, (block,),
                         {"rot": t(fixed, torch.bool)}, LMOptions(max_iters=max_iters))
    return out["rot"].cpu().numpy(), info


def rotation_averaging_l1(n_frames, pair_i, pair_j, rel_aa, weights=None,
                          device="cpu"):
    """Spanning tree, X84, exact L1 refinement, X84 again, Huber L2 solve
    (EstimateGlobalRotation, sfm/SfM.cpp:811-905). Returns (aa_fw (N,3),
    valid (N,), keep (M,))."""
    from ..solver.l1_admm import rotation_refine_l1_irls
    aa0, valid = spanning_tree_init(n_frames, pair_i, pair_j, rel_aa, weights)
    keep = filter_pairs_x84(pair_i, pair_j, rel_aa, aa0)
    start = int(np.argmax(valid))
    aa1 = rotation_refine_l1_irls(n_frames, np.asarray(pair_i)[keep],
                                  np.asarray(pair_j)[keep], np.asarray(rel_aa)[keep],
                                  aa0, start_idx=start, weight_function=1,
                                  device=device)
    mask = filter_pairs_x84(pair_i, pair_j, rel_aa, aa1)
    aa2, _ = _solve(aa1, pair_i, pair_j, rel_aa, mask, "huber",
                    float(np.radians(2.0)), 30, start, device)
    return aa2, valid, mask


def rotation_averaging_l2(n_frames, pair_i, pair_j, rel_aa, weights=None,
                          device="cpu"):
    """ROTATION_AVERAGING_L2: the spectral init when the pair graph is
    connected (else the spanning tree), X84, one Huber L2 solve."""
    uf = UnionFind(n_frames)
    for a, b in zip(np.asarray(pair_i), np.asarray(pair_j)):
        uf.union(int(a), int(b))
    if len({uf.find(i) for i in range(n_frames)}) == 1:
        aa0, valid = rotation_averaging_least_square(n_frames, pair_i, pair_j,
                                                     rel_aa, weights)
    else:
        aa0, valid = spanning_tree_init(n_frames, pair_i, pair_j, rel_aa, weights)
    mask = filter_pairs_x84(pair_i, pair_j, rel_aa, aa0)
    aa1, _ = _solve(aa0, pair_i, pair_j, rel_aa, mask, "huber",
                    float(np.radians(2.0)), 40, int(np.argmax(valid)), device)
    return aa1, valid, mask


def rotation_averaging(n_frames, pair_i, pair_j, rel_aa, weights=None,
                       method: int = 1, device="cpu"):
    """RotationAveragingMethod (sfm/SfM.h:65-68): 1 = L1, 2 = L2."""
    fn = rotation_averaging_l2 if method == 2 else rotation_averaging_l1
    return fn(n_frames, pair_i, pair_j, rel_aa, weights, device=device)
