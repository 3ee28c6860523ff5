"""Essential-matrix estimation on unit-sphere bearings — the port of
panovlm_tpu/ops/epipolar.py (base/EssentialMatrix.{h,cpp} and
base/ACRansac_NFA.{h,cpp} of the reference), batched over image pairs.

Every function takes a leading pair axis P: bearings b1, b2 (P, M, 3), masks
(P, M). AC-RANSAC draws all hypotheses up front, scores them as one batched
program (pair x hypothesis x match), keeps the best by NFA and refits E on
its inliers, as the JAX module does.

The JAX module draws the 8-point samples with `jax.random.randint` keyed by
the pair id. Here they are an argument (`draws`), so a test can inject
jax.random's; without it they come from a `torch.Generator` (ROADMAP F5).

The minimal 8-point null vector is the last column of the complete Q of
A^T (as the JAX module takes it from `jnp.linalg.qr`), computed here by
eight batched Householder reflections in LAPACK's sign convention, so no
batched factorization library call runs per hypothesis.
"""

from __future__ import annotations

import math

import torch

MIN_SAMPLE = 8


def _design(b1, b2):
    """Rows of the epipolar constraint: coefficient of E_ij is p2_i p1_j."""
    return (b2[..., :, :, None] * b1[..., :, None, :]).reshape(*b1.shape[:-2], -1, 9)


def _null_vector_8x9(A):
    """Last column of the complete Q of A^T for A (..., 8, 9), by
    Householder reflections (LAPACK geqrf/orgqr conventions)."""
    R = A.transpose(-1, -2).clone()                       # (..., 9, 8)
    vs, taus = [], []
    for k in range(8):
        col = R[..., k:, k]
        alpha = col[..., 0]
        xnorm = torch.linalg.vector_norm(col[..., 1:], dim=-1)
        beta = -torch.copysign(torch.hypot(alpha, xnorm), alpha)
        nz = (xnorm > 0) & (beta != 0) & (alpha != beta)
        beta_s = torch.where(nz, beta, torch.ones_like(beta))
        tau = torch.where(nz, (beta_s - alpha) / beta_s, torch.zeros_like(alpha))
        denom = torch.where(nz, alpha - beta_s, torch.ones_like(alpha))
        v = torch.cat([torch.ones_like(alpha)[..., None],
                       col[..., 1:] / denom[..., None]], dim=-1)
        v = torch.where(nz[..., None], v, torch.nn.functional.pad(
            torch.ones_like(alpha)[..., None], (0, 8 - k)))
        sub = R[..., k:, k:]
        R[..., k:, k:] = sub - tau[..., None, None] * v[..., :, None] * (
            v[..., None, :] @ sub)
        vs.append(v)
        taus.append(tau)
    y = torch.zeros(A.shape[:-2] + (9,), dtype=A.dtype, device=A.device)
    y[..., 8] = 1.0
    for k in range(7, -1, -1):
        yk = y[..., k:]
        y = torch.cat([y[..., :k], yk - taus[k][..., None] * vs[k]
                       * torch.sum(vs[k] * yk, -1, keepdim=True)], dim=-1)
    return y


def _rank2(E0):
    U, s, Vt = torch.linalg.svd(E0)
    s2 = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (U * s2[..., None, :]) @ Vt


def eight_point(b1, b2):
    """Essential matrix from minimal 8-pair samples (..., 8, 3): the exact
    null vector of A, projected to rank 2. Returns (..., 3, 3)."""
    e = torch.nan_to_num(_null_vector_8x9(_design(b1, b2)), 0.0, 0.0, 0.0)
    return _rank2(e.reshape(*e.shape[:-1], 3, 3))


def eight_point_masked(b1, b2, w):
    """Weighted refit over (..., M) rows: smallest eigenvector of A^T A."""
    A = _design(b1, b2) * w[..., :, None]
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    e = vecs[..., :, 0]
    return _rank2(e.reshape(*e.shape[:-1], 3, 3))


def epipolar_residuals(E, b1, b2):
    """asin^2 of the angle between b2 and the epipolar plane of b1.
    E (..., 3, 3), b1/b2 (..., M, 3) -> (..., M)."""
    ep2 = b1 @ E.transpose(-1, -2)
    ep2 = ep2 / (torch.linalg.vector_norm(ep2, dim=-1, keepdim=True) + 1e-12)
    s = torch.sum(ep2 * b2, dim=-1)
    return torch.arcsin(torch.clamp(s, -1.0, 1.0)) ** 2


def _log10_binom(n, k):
    return (torch.lgamma(n + 1.0) - torch.lgamma(k + 1.0)
            - torch.lgamma(n - k + 1.0)) / math.log(10.0)


def acransac_nfa(residuals, mask):
    """A-contrario NFA over sorted residuals (ACRansac_NFA::ComputeNFA),
    residuals (..., M), mask broadcastable to it. Returns (nfa, err
    threshold, ok), each (...)."""
    M = residuals.shape[-1]
    n_valid = torch.sum(mask, dim=-1).to(residuals.dtype)
    r_sorted, _ = torch.sort(torch.where(mask, residuals, torch.full_like(residuals, math.inf)),
                             dim=-1)
    ks = torch.arange(1, M + 1, dtype=residuals.dtype, device=residuals.device)
    nv = n_valid[..., None]
    log_e0 = torch.log10(torch.clamp_min(nv - MIN_SAMPLE, 1.0))
    log_alpha = math.log10(0.5) + 0.25 * torch.log10(r_sorted + 1.2e-7)
    nfa_k = (log_e0 + log_alpha * (ks - MIN_SAMPLE) + _log10_binom(nv, ks)
             + _log10_binom(ks, torch.full_like(ks, float(MIN_SAMPLE))))
    valid_k = (ks > MIN_SAMPLE) & (ks <= nv) & torch.isfinite(r_sorted)
    nfa_k = torch.where(valid_k, nfa_k, torch.full_like(nfa_k, math.inf))
    best = torch.argmin(nfa_k, dim=-1, keepdim=True)
    nfa = torch.gather(nfa_k, -1, best)[..., 0]
    err = torch.gather(r_sorted, -1, best)[..., 0]
    ok = (nfa < 0) & ((best[..., 0] + 1) > MIN_SAMPLE)
    return nfa, err, ok


def decompose_essential(E):
    """E (..., 3, 3) -> 4 candidate (R_21, t_21): (..., 4, 3, 3), (..., 4, 3)."""
    U, _, Vt = torch.linalg.svd(E)
    t = U[..., :, 2]
    t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-12)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    R1 = R1 * torch.sign(torch.linalg.det(R1))[..., None, None]
    R2 = R2 * torch.sign(torch.linalg.det(R2))[..., None, None]
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def triangulate_two_view(R_21, t_21, b1, b2):
    """Midpoint triangulation (sfm/Triangulate.cpp:8-28) of bearings
    b1/b2 (..., M, 3) for poses R_21 (..., 3, 3), t_21 (..., 3); points in
    frame 1."""
    R_12 = R_21.transpose(-1, -2)
    d1 = b1
    d2 = b2 @ R_21                                  # rows of R_12 b2
    c2 = -(R_12 @ t_21[..., None])[..., 0][..., None, :]
    a11 = torch.sum(d1 * d1, dim=-1)
    a12 = -torch.sum(d1 * d2, dim=-1)
    a22 = torch.sum(d2 * d2, dim=-1)
    r1 = torch.sum(d1 * c2, dim=-1)
    r2 = -torch.sum(d2 * c2, dim=-1)
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    s1 = (a22 * r1 - a12 * r2) / det
    s2 = (a11 * r2 - a12 * r1) / det
    return 0.5 * (s1[..., None] * d1 + c2 + s2[..., None] * d2)


def _deg_arccos(c):
    return torch.rad2deg(torch.arccos(torch.clamp(c, -1.0, 1.0)))


def check_rt(R_21, t_21, b1, b2, mask, reproj_angle_deg: float = 3.0):
    """SfM::CheckRT (sfm/SfM.cpp:1478-1547): triangulate, keep finite points
    seen within 3 deg in both views. Returns (n_good (...), good (..., M),
    points (..., M, 3) in frame 1). (The JAX function's parallax, which no
    caller reads, is not computed.)"""
    pts = triangulate_two_view(R_21, t_21, b1, b2)
    finite = torch.all(torch.isfinite(pts), dim=-1)
    n1 = pts / (torch.linalg.vector_norm(pts, dim=-1, keepdim=True) + 1e-12)
    ang1 = _deg_arccos(torch.sum(n1 * b1, dim=-1))
    p2 = pts @ R_21.transpose(-1, -2) + t_21[..., None, :]
    p2n = p2 / (torch.linalg.vector_norm(p2, dim=-1, keepdim=True) + 1e-12)
    ang2 = _deg_arccos(torch.sum(p2n * b2, dim=-1))
    good = mask & finite & (ang1 <= reproj_angle_deg) & (ang2 <= reproj_angle_deg)
    return torch.sum(good, dim=-1), good, pts


def draw_samples(mask, n_hyp: int, generator: torch.Generator):
    """Uniform 8-point draws in [0, max(n_valid, 1)) per pair: (P, n_hyp, 8)."""
    n_valid = torch.clamp_min(torch.sum(mask, dim=-1), 1)
    u = torch.rand((mask.shape[0], n_hyp, MIN_SAMPLE), generator=generator,
                   device=mask.device)
    return torch.minimum((u * n_valid[:, None, None]).long(), n_valid[:, None, None] - 1)


def find_essential_acransac(b1, b2, mask, draws):
    """Batched AC-RANSAC. b1, b2 (P, M, 3), mask (P, M), draws (P, H, 8)
    indices into each pair's valid matches. Returns dict E (P, 3, 3),
    inliers (P, M), nfa, err_threshold, ok (P,)."""
    P = b1.shape[0]
    valid_idx = torch.argsort((~mask).to(torch.int8), dim=-1, stable=True)
    samples = torch.gather(valid_idx, 1, draws.reshape(P, -1)).reshape(draws.shape)
    rows = torch.arange(P, device=b1.device)[:, None, None]
    E_h = eight_point(b1[rows, samples], b2[rows, samples])          # (P, H, 3, 3)
    res = epipolar_residuals(E_h, b1[:, None], b2[:, None])           # (P, H, M)
    nfa, err, ok = acransac_nfa(res, mask[:, None, :])
    nfa = torch.where(ok, nfa, torch.full_like(nfa, math.inf))
    best = torch.argmin(nfa, dim=1)
    pr = torch.arange(P, device=b1.device)
    inliers = (res[pr, best] < err[pr, best][:, None]) & mask
    E = eight_point_masked(b1, b2, inliers.to(b1.dtype))
    nfa_b = nfa[pr, best]
    return {"E": E, "inliers": inliers, "nfa": nfa_b,
            "err_threshold": err[pr, best], "ok": ok[pr, best] & torch.isfinite(nfa_b)}


def best_pose_from_essential(E, b1, b2, inliers):
    """DecomposeEssential + CheckRT best-of-4, batched over pairs. Returns
    dict R_21 (P, 3, 3), t_21 (P, 3), n_good (P,), good (P, M), points
    (P, M, 3)."""
    Rs, ts = decompose_essential(E)                                   # (P, 4, ...)
    n_good, good, pts = check_rt(Rs, ts, b1[:, None], b2[:, None], inliers[:, None])
    best = torch.argmax(n_good, dim=1)
    pr = torch.arange(E.shape[0], device=E.device)
    return {"R_21": Rs[pr, best], "t_21": ts[pr, best], "n_good": n_good[pr, best],
            "good": good[pr, best], "points": pts[pr, best]}
