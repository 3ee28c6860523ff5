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

`index_sum` and `scatter_sum` make scattered float sums
reproducible: `index_add_` and `scatter_add_` of float32 on the card add
with atomics in an order that changes from run to run (ROADMAP F8). Here
every term is rounded to a multiple of 2^-40 and summed as int64, which is
exact and so does not depend on the order; the sum is then rounded once to
float32. The result is the same on the card and on the CPU, within
2^-40 per term of the exact sum (terms must stay below 2^22 in magnitude,
sums below 2^23).
"""

from __future__ import annotations

import numpy as np
import torch


FIXED_BITS = 40


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


def to_fixed(x):
    """float tensor -> int64 multiples of 2^-FIXED_BITS (round to nearest)."""
    return torch.round(x.double() * 2.0 ** FIXED_BITS).to(torch.int64)


def from_fixed(n, dtype=torch.float32):
    """int64 fixed-point sums -> dtype, rounded once."""
    return (n.double() * 2.0 ** -FIXED_BITS).to(dtype)


def index_sum(n: int, index, src):
    """zeros((n, *src.shape[1:])).index_add_(0, index, src), summed in fixed
    point: the same bits on every run and device."""
    acc = torch.zeros((n, *src.shape[1:]), dtype=torch.int64, device=src.device)
    return from_fixed(acc.index_add_(0, index, to_fixed(src)), src.dtype)


def scatter_sum(n: int, parts):
    """The sum over (index, src) in parts of
    zeros((*src.shape[:-1], n)).scatter_add_(-1, index, src), in fixed point:
    the same bits on every run and device."""
    acc = None
    for index, src in parts:
        if acc is None:
            acc = torch.zeros((*src.shape[:-1], n), dtype=torch.int64, device=src.device)
        acc.scatter_add_(-1, index, to_fixed(src))
    return from_fixed(acc, src.dtype)
