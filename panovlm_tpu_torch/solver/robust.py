"""Robust loss functions (Ceres-compatible), ported from
`panovlm_tpu/solver/robust.py`. rho(s) takes the squared residual norm s;
the solver's IRLS weight is sqrt(rho'(s))."""

from __future__ import annotations

import torch

TRIVIAL = "trivial"
HUBER = "huber"
SOFT_L1 = "soft_l1"
CAUCHY = "cauchy"


def rho(loss: str, s, scale: float):
    """Loss value rho(s); s = squared norm."""
    a2 = scale * scale
    if loss == TRIVIAL:
        return s
    if loss == HUBER:
        return torch.where(s <= a2, s,
                           2.0 * scale * torch.sqrt(torch.clamp_min(s, 1e-30)) - a2)
    if loss == SOFT_L1:
        return 2.0 * a2 * (torch.sqrt(1.0 + s / a2) - 1.0)
    if loss == CAUCHY:
        return a2 * torch.log1p(s / a2)
    raise ValueError(f"unknown loss {loss}")


def rho_prime(loss: str, s, scale: float):
    """rho'(s)."""
    a2 = scale * scale
    if loss == TRIVIAL:
        return torch.ones_like(s)
    if loss == HUBER:
        return torch.where(s <= a2, torch.ones_like(s),
                           scale / torch.sqrt(torch.clamp_min(s, 1e-30)))
    if loss == SOFT_L1:
        return 1.0 / torch.sqrt(1.0 + s / a2)
    if loss == CAUCHY:
        return 1.0 / (1.0 + s / a2)
    raise ValueError(f"unknown loss {loss}")
