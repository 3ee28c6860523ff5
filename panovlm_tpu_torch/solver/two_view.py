"""Two-view chordal refinement — the port of panovlm_tpu/solver/two_view.py
(the two-view Ceres problem of FilterImagePairs, sfm/SfM.cpp:298-480),
batched over image pairs.

Per pair: camera 0 is the gauge, camera 1 is the only pose block, every
point couples only to it, so each LM iteration is K batched 3x3 point
factors (closed-form inverse), one 6x6 reduced solve and K
back-substitutions. Huber-IRLS weights, Marquardt diag(JtJ) damping and
Nielsen's lambda rule as in the JAX solver; each pair keeps its own lambda
and stops on its own test (the JAX module's vmapped while_loop freezes a
finished lane the same way).
"""

from __future__ import annotations

import torch
from torch.func import jacrev, vmap

from . import robust
from ..ops import se3

_EPS = 1e-10


def _inv3(A):
    """Closed-form adjugate inverse of (..., 3, 3) blocks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00, A01, A02 = e * i - f * h, c * h - b * i, b * f - c * e
    A10, A11, A12 = f * g - d * i, a * i - c * g, c * d - a * f
    A20, A21, A22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A00 + b * A10 + c * A20
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    adj = torch.stack([torch.stack([A00, A01, A02], -1),
                       torch.stack([A10, A11, A12], -1),
                       torch.stack([A20, A21, A22], -1)], -2)
    return adj * inv_det[..., None, None]


def _r0(X, b1):
    return X / (torch.linalg.vector_norm(X) + 1e-12) - b1


def _r1(pose, X, b2):
    p_c = se3.exp_so3(pose[:3]) @ X + pose[3:]
    return p_c / (torch.linalg.vector_norm(p_c) + 1e-12) - b2


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def two_view_refine(pose0, pts0, b1, b2, good, loss_scale: float,
                    max_iters: int = 10, loss: str = "huber"):
    """LM over (pose1 (P, 6), points (P, K, 3)) with per-point Schur
    elimination. b1/b2 (P, K, 3) unit bearings, good (P, K). Returns
    (pose (P, 6), pts (P, K, 3), cost (P,))."""
    P, K, _ = pts0.shape
    mask = good.to(torch.float32)
    dev = pts0.device
    r0_fn = vmap(vmap(_r0))
    r1_fn = vmap(vmap(_r1, in_dims=(None, 0, 0)))
    j0_fn = vmap(vmap(jacrev(_r0)))
    j1_fn = vmap(vmap(jacrev(_r1, argnums=(0, 1)), in_dims=(None, 0, 0)))

    def cost_irls(pose, pts):
        r0 = r0_fn(pts, b1)
        r1 = r1_fn(pose, pts, b2)
        s0, s1 = torch.sum(r0 * r0, -1), torch.sum(r1 * r1, -1)
        cost = 0.5 * torch.sum(mask * (robust.rho(loss, s0, loss_scale)
                                       + robust.rho(loss, s1, loss_scale)), dim=1)
        w0 = torch.sqrt(robust.rho_prime(loss, s0, loss_scale)) * mask
        w1 = torch.sqrt(robust.rho_prime(loss, s1, loss_scale)) * mask
        return cost, (r0, r1, w0, w1)

    pose = pose0.to(torch.float32).clone()
    pts = pts0.to(torch.float32).clone()
    lam = torch.full((P,), 1e-4, device=dev)
    nu = torch.full((P,), 2.0, device=dev)
    active = torch.ones(P, dtype=torch.bool, device=dev)
    eye3 = torch.eye(3, device=dev)
    for _ in range(max_iters):
        cost, (r0, r1, w0, w1) = cost_irls(pose, pts)
        J0x = _finite(j0_fn(pts, b1) * w0[..., None, None])
        J1p, J1x = j1_fn(pose, pts, b2)
        J1p = _finite(J1p * w1[..., None, None])                      # (P, K, 3, 6)
        J1x = _finite(J1x * w1[..., None, None])                      # (P, K, 3, 3)
        r0w = _finite(r0) * w0[..., None]
        r1w = _finite(r1) * w1[..., None]
        V = (torch.einsum("pkri,pkrj->pkij", J0x, J0x)
             + torch.einsum("pkri,pkrj->pkij", J1x, J1x))
        U = torch.einsum("pkri,pkrj->pkij", J1p, J1x)                 # (P, K, 6, 3)
        Hpp = torch.einsum("pkri,pkrj->pij", J1p, J1p)
        g_p = torch.einsum("pkri,pkr->pi", J1p, r1w)
        g_x = (torch.einsum("pkri,pkr->pki", J0x, r0w)
               + torch.einsum("pkri,pkr->pki", J1x, r1w))
        dVd = torch.diagonal(V, dim1=-2, dim2=-1)
        Vd = V + (lam[:, None, None] * (dVd + _EPS) + (1.0 - mask)[..., None]) [..., None] * eye3
        Vinv = _inv3(Vd)
        Y = U @ Vinv
        D2p = torch.diagonal(Hpp, dim1=-2, dim2=-1)
        S = (Hpp + torch.diag_embed(lam[:, None] * (D2p + _EPS))
             - torch.einsum("pkil,pkjl->pij", Y, U))
        rhs = -g_p + torch.einsum("pkil,pkl->pi", Y, g_x)
        dp = torch.linalg.solve(S, rhs[..., None])[..., 0]
        dx = torch.einsum("pkij,pkj->pki", Vinv,
                          -g_x - torch.einsum("pkrj,pr->pkj", U, dp)) * mask[..., None]
        pred = (0.5 * torch.sum(dp * (lam[:, None] * (D2p + _EPS) * dp - g_p), -1)
                + 0.5 * torch.sum(dx * (lam[:, None, None] * (dVd + _EPS) * dx - g_x),
                                  dim=(1, 2)))
        pose_new, pts_new = pose + dp, pts + dx
        cost_new, _ = cost_irls(pose_new, pts_new)
        gain = (cost - cost_new) / torch.clamp_min(pred, 1e-30)
        accept = (cost_new < cost) & (pred > 0) & active
        pose = torch.where(accept[:, None], pose_new, pose)
        pts = torch.where(accept[:, None, None], pts_new, pts)
        lam_acc = lam * torch.clamp_min(1.0 - (2.0 * gain - 1.0) ** 3, 1.0 / 3.0)
        lam_new = torch.clamp(torch.where(accept, lam_acc, lam * nu), 1e-12, 1e10)
        nu_new = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        lam = torch.where(active, lam_new, lam)
        nu = torch.where(active, nu_new, nu)
        rel_drop = (cost - cost_new) / torch.clamp_min(cost, 1e-30)
        active = active & ~(accept & (rel_drop < 1e-9))
        if not bool(active.any()):
            break
    cost, _ = cost_irls(pose, pts)
    return pose, pts, cost
