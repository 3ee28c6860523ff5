"""Float32 arithmetic evaluated the way the JAX package's compiled programs
evaluate it, so that the frontend's threshold decisions (which cell wins,
which point is picked, which point is an inlier) come out bit-equal.

XLA's CPU backend contracts a multiply feeding an add into one fused
multiply-add: `a*b + c*d` becomes fma(a, b, c*d), `a - b*c` becomes
fma(-b, c, a), and a sum-reduction of products chains fmas from the first
product. `fma` below computes a fused multiply-add exactly in float64 (the
product of two float32 values is exact there) and rounds once to float32,
on any device. `sqrt` is correctly rounded on any device (PyTorch's
vectorized CPU sqrt is not; the JAX package's is). XLA also rewrites
`x / const` as `x * (1 / const)` (`div_const`), while PyTorch's `c / tensor`
multiplies by the reciprocal where JAX divides (`rdiv`).
"""

from __future__ import annotations

import numpy as np
import torch


def f32(v: float) -> float:
    """A Python float rounded to the nearest float32 value."""
    return float(np.float32(v))


def div_const(x, c: float):
    """x / c for a constant c as XLA compiles it: x * float32(1 / float32(c))."""
    return x * f32(1.0 / f32(c))


def rdiv(c: float, x):
    """c / x as a true float32 division."""
    return torch.div(torch.tensor(c, dtype=x.dtype, device=x.device), x)


def mod(x, y: float):
    """jnp.mod for floats: fmod, then shifted into the divisor's sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def fma(a, b, c):
    """float32 a * b + c with a single rounding."""
    return torch.addcmul(c.double(), a.double(), b.double()).to(torch.float32)


def sqrt(x):
    return torch.sqrt(x.double()).to(x.dtype)


def dot3(a, b):
    """sum(a * b, axis=-1) over a last axis of 3, as the reduction runs:
    fma(a2, b2, fma(a1, b1, a0 * b0))."""
    return fma(a[..., 2], b[..., 2], fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


def sumsq3(v):
    """sum(v * v, axis=-1) over a last axis of 3."""
    return dot3(v, v)


def norm3(v):
    """jnp.linalg.norm over a last axis of 3."""
    return sqrt(sumsq3(v))


def sum_of_products(pairs):
    """a0*b0 + a1*b1 + ... written as elementwise expression (not a
    reduction): fma(a_k, b_k, ... fma(a0, b0, a1*b1))."""
    (a0, b0), (a1, b1), *rest = pairs
    acc = fma(a0, b0, a1 * b1)
    for a, b in rest:
        acc = fma(a, b, acc)
    return acc
