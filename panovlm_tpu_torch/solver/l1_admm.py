"""L1 rotation refinement (Chatterjee-Govindu L1RA then IRLS) — the port of
`rotation_refine_l1_irls` and `refine_rotations_l1_irls` of
panovlm_tpu/solver/l1_admm.py (sfm/RotationAveraging.cpp:428-582 and the
ADMM L1 solver of sfm/l1_solver_admm.hpp in the reference).

The system matrix is the signed incidence of the pair graph with the start
camera's column deleted, times I_3, so A^T A is the reduced graph Laplacian
per coordinate: A x is a gather-subtract over edge endpoints, A^T v one
exact scattered sum (ops/exact.index_sum, ROADMAP F9), and one Cholesky
factor of the unweighted Laplacian serves every
ADMM iteration. The loops read their stopping tests each iteration, as the
JAX while_loops do.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import se3
from ..ops.exact import index_sum


def _shrinkage(v, kappa):
    return torch.clamp_min(v - kappa, 0.0) - torch.clamp_min(-v - kappa, 0.0)


def _reduced_graph(pair_i, pair_j, start_idx: int, device):
    pair_i = np.asarray(pair_i, np.int64)
    pair_j = np.asarray(pair_j, np.int64)
    mi = pair_i != start_idx
    mj = pair_j != start_idx
    gi = np.where(mi, pair_i - (pair_i >= start_idx), 0)
    gj = np.where(mj, pair_j - (pair_j >= start_idx), 0)

    def t(a, dt):
        return torch.as_tensor(a, dtype=dt, device=device)
    return (t(gi, torch.int64), t(gj, torch.int64), t(mi, torch.float32),
            t(mj, torch.float32))


def _apply_A(x, gi, gj, mi, mj):
    return x[gj] * mj[:, None] - x[gi] * mi[:, None]


def _apply_At(v, gi, gj, mi, mj, n_red):
    return index_sum(n_red, torch.cat([gj, gi]),
                     torch.cat([v * mj[:, None], -v * mi[:, None]]))


def _laplacian(gi, gj, mi, mj, n_red, w):
    """Reduced Laplacian per channel: w (M, C) -> (C, n_red, n_red)."""
    w = w.T                                                  # (C, M)
    C = w.shape[0]
    parts = ((gi, gi, mi * mi), (gj, gj, mj * mj), (gi, gj, -mi * mj), (gj, gi, -mi * mj))
    L = index_sum(n_red * n_red, torch.cat([a * n_red + b for a, b, _ in parts]),
                  torch.cat([(w * m[None]).T for _, _, m in parts])).T
    eye = torch.eye(n_red, device=w.device)
    return L.reshape(C, n_red, n_red) + 1e-8 * eye


def _pair_log_errors(R, pi, pj, R_rel):
    E = R[pj].transpose(-1, -2) @ R_rel @ R[pi]
    return se3.log_so3(E)


def _scatter_update(R, x_r, start_idx: int):
    n = R.shape[0]
    idx = torch.as_tensor([i - (i >= start_idx) if i != start_idx else 0
                           for i in range(n)], device=R.device)
    keep = torch.as_tensor([i != start_idx for i in range(n)], device=R.device)
    full = torch.where(keep[:, None], x_r[idx], torch.zeros((), device=R.device))
    return R @ se3.exp_so3(full)


def refine_rotations_l1_irls(R0, pi, pj, R_rel, gi, gj, mi, mj, start_idx: int,
                             weight_function: int = 1, max_outer: int = 32,
                             admm_iters: int = 400):
    """RotationAveragingRefineL1: L1-ADMM outer loop, then IRLS. R0 (N,3,3)
    world->camera (R0[start_idx] = I), R_rel (M,3,3) measured R_ji."""
    n, m = R0.shape[0], R_rel.shape[0]
    n_red = n - 1
    dev = R0.device
    L = _laplacian(gi, gj, mi, mj, n_red, torch.ones((m, 1), device=dev))[0]
    chol = torch.linalg.cholesky(L)
    pri_eps0 = float(np.sqrt(3 * m) * 1e-4)
    dua_eps0 = float(np.sqrt(3 * n_red) * 1e-4)

    def admm(b):
        b_norm = torch.linalg.vector_norm(b)
        x = torch.zeros((n_red, 3), device=dev)
        z = torch.zeros((m, 3), device=dev)
        u = torch.zeros((m, 3), device=dev)
        for _ in range(admm_iters):
            x = torch.cholesky_solve(_apply_At(b + z - u, gi, gj, mi, mj, n_red), chol)
            ax = _apply_A(x, gi, gj, mi, mj)
            z_new = _shrinkage(ax - b + u, 1.0)
            u = u + (ax - z_new - b)
            r_norm = torch.linalg.vector_norm(ax - z_new - b)
            s_norm = torch.linalg.vector_norm(_apply_At(z_new - z, gi, gj, mi, mj, n_red))
            max_norm = torch.maximum(torch.maximum(torch.linalg.vector_norm(ax),
                                                   torch.linalg.vector_norm(z_new)), b_norm)
            done = ((r_norm < pri_eps0 + 1e-2 * max_norm)
                    & (s_norm < dua_eps0 + 1e-2 * torch.linalg.vector_norm(
                        _apply_At(u, gi, gj, mi, mj, n_red))))
            z = z_new
            if bool(done):
                break
        return x

    big = float(np.finfo(np.float32).max)
    R, last_e, curr_e, it = R0, big, big, 0
    while it == 0 or (it < max_outer and curr_e > 1e-5
                      and (last_e - curr_e) / curr_e > 1e-2):
        x = admm(_pair_log_errors(R, pi, pj, R_rel))
        last_e, curr_e = curr_e, float(torch.linalg.vector_norm(x))
        it += 1
        if last_e < curr_e:                       # error grew: keep R
            break
        R = _scatter_update(R, x, start_idx)

    sq_sigma = (5.0 * np.pi / 180.0) ** 2
    x = torch.zeros((n_red, 3), device=dev)
    last_e, curr_e, it = big, big, 0
    while it == 0 or (it < max_outer and curr_e > 1e-5
                      and (last_e - curr_e) / curr_e > 1e-2):
        b = _pair_log_errors(R, pi, pj, R_rel)
        e = _apply_A(x, gi, gj, mi, mj) - b
        if weight_function == 1:
            w = torch.clamp_max(torch.abs(e) ** -1.5, 1e6)
        else:
            w = sq_sigma / (e * e + sq_sigma) ** 2
        Lw = _laplacian(gi, gj, mi, mj, n_red, w)
        rhs = _apply_At(w * b, gi, gj, mi, mj, n_red)
        x_new = torch.linalg.solve(Lw, rhs.T[..., None])[..., 0].T
        R = _scatter_update(R, x_new, start_idx)
        last_e, curr_e = curr_e, float(torch.linalg.vector_norm(x - x_new))
        x = x_new
        it += 1
    return R


def rotation_refine_l1_irls(n_frames, pair_i, pair_j, rel_aa, aa0,
                            start_idx: int = 0, weight_function: int = 1,
                            device="cpu"):
    """Axis-angle in and out around refine_rotations_l1_irls; the gauge
    camera is re-anchored to identity first. Returns (N, 3) numpy."""
    R0 = se3.exp_so3(torch.as_tensor(np.asarray(aa0), dtype=torch.float32, device=device))
    R0 = R0 @ R0[start_idx].T
    R_rel = se3.exp_so3(torch.as_tensor(np.asarray(rel_aa), dtype=torch.float32,
                                        device=device))
    gi, gj, mi, mj = _reduced_graph(pair_i, pair_j, start_idx, device)
    R = refine_rotations_l1_irls(
        R0, torch.as_tensor(np.asarray(pair_i), dtype=torch.int64, device=device),
        torch.as_tensor(np.asarray(pair_j), dtype=torch.int64, device=device),
        R_rel, gi, gj, mi, mj, start_idx, weight_function)
    return se3.log_so3(R).cpu().numpy().astype(np.float32)
