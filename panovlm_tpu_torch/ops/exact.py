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

`index_sum` and `scatter_sum` make scattered float sums reproducible:
`index_add_` and `scatter_add_` of float32 on the card add with atomics in
an order that changes from run to run (ROADMAP F8, F9). Here every term is
rounded to a fixed point scaled by the largest |term| of the call, split
into two int64 words and summed exactly, so the integer sums do not depend
on the order of the terms (up to 2^32 terms per destination); the two sums
are joined in float64 and rounded once. The result is the same on the card
and on the CPU, within (terms) x 2^-62 x max|term| of the exact sum before
that rounding. The device SIFT and VLAD (F8), the LM normal equations,
translation averaging, L1-ADMM and the voxel grid (F9) sum through them.

With a process group (`parallel.sharding.DataGroup`) the terms are spread
over its ranks: the scale comes from an all-reduce MAX of every rank's
largest |term| and the two words from an all-reduce SUM, so the sum has the
same bits however the terms are split, one rank included. `group_sum` is
the exact total of a tensor (the LM costs).
"""

from __future__ import annotations

import math

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


# terms converted to fixed point at a time: bounds the int64 temporaries
# of a sum to CHUNK x 16 bytes whatever its number of terms
CHUNK = 1 << 22
LO_MASK = (1 << 31) - 1


def _fixed_scale(srcs, group=None):
    """2^(62 - e), where 2^e bounds the largest |term| of every src (of
    every rank's, with a group)."""
    big = torch.zeros((), dtype=torch.float64, device=srcs[0].device)
    for s in srcs:
        if s.numel():
            lo, hi = torch.aminmax(s)
            big = torch.maximum(big, torch.maximum(lo.abs(), hi.abs()).double())
    if group is not None:
        big = group.all_reduce(big, "max")
    e = torch.frexp(big).exponent
    return torch.ldexp(torch.ones((), dtype=torch.float64, device=big.device),
                       torch.clamp(62 - e, max=1000))


def _add_fixed(acc_hi, acc_lo, add, src, scale):
    """Adds the low and high int64 words of src in fixed point into acc_lo
    and acc_hi, about CHUNK terms at a time: add(acc, words, r0, r1)
    scatters the words of src's rows r0:r1."""
    rows = max(1, CHUNK // max(1, math.prod(src.shape[1:])))
    for r0 in range(0, src.shape[0], rows):
        q = src[r0:r0 + rows].to(torch.float64, copy=True).mul_(scale).round_().to(torch.int64)
        lo = torch.bitwise_and(q, LO_MASK)
        add(acc_lo, lo, r0, r0 + rows)
        del lo
        add(acc_hi, q.bitwise_right_shift_(31), r0, r0 + rows)


def _join(acc_hi, acc_lo, scale, dtype, group=None):
    if group is not None:
        acc_hi, acc_lo = group.all_reduce(torch.stack([acc_hi, acc_lo]), "sum")
    return (acc_hi.double().mul_(2.0 ** 31).add_(acc_lo.double()).div_(scale)).to(dtype)


def index_sum(n: int, index, src, group=None, *, scale_only: bool = False):
    """zeros((n, *src.shape[1:])).index_add_(0, index, src) for finite float
    terms: the same bits on every run, device and order of the terms. Each
    term is rounded to a multiple of 2^(e - 62), where 2^e bounds the
    largest |term|, split into a high and a low int64 word and summed
    exactly; the two sums are joined in float64 and rounded once.

    group: the terms of every rank of the group are summed, and every rank
    gets the sum (each rank must call, with its own terms, maybe none).
    scale_only: only the scale is the group's; the words stay this rank's
    (sums whose destinations all lie on one rank, as the per-run sums of a
    block sharded at run boundaries)."""
    out_shape = (n, *src.shape[1:])
    if src.numel() == 0 and group is None:
        return torch.zeros(out_shape, dtype=src.dtype, device=src.device)
    scale = _fixed_scale([src], group)
    acc_hi, acc_lo = (torch.zeros(out_shape, dtype=torch.int64, device=src.device)
                      for _ in range(2))
    _add_fixed(acc_hi, acc_lo, lambda acc, w, r0, r1: acc.index_add_(0, index[r0:r1], w),
               src, scale)
    return _join(acc_hi, acc_lo, scale, src.dtype, None if scale_only else group)


def group_sum(x, group=None):
    """x.sum() as `index_sum` sums it: exact in fixed point, the same bits
    however the terms lie over the group's ranks. Returns a 0-d tensor."""
    flat = x.reshape(-1)
    return index_sum(1, torch.zeros(flat.shape, dtype=torch.int64, device=x.device),
                     flat, group)[0]


def scatter_sum(n: int, parts, group=None):
    """The sum over (index, src) in parts of
    zeros((*src.shape[:-1], n)).scatter_add_(-1, index, src), in the words
    of `index_sum` with one scale for every part, over the group's ranks
    when a group is given."""
    parts = list(parts)
    lead = parts[0][1].shape[:-1]
    parts = [(index.reshape(-1, index.shape[-1]), src.reshape(-1, src.shape[-1]))
             for index, src in parts]
    scale = _fixed_scale([src for _, src in parts], group)
    dev = parts[0][1].device
    acc_hi, acc_lo = (torch.zeros((parts[0][1].shape[0], n), dtype=torch.int64, device=dev)
                      for _ in range(2))
    for index, src in parts:
        _add_fixed(acc_hi, acc_lo,
                   lambda acc, w, r0, r1, index=index:
                   acc[r0:r1].scatter_add_(-1, index[r0:r1].long(), w), src, scale)
    return _join(acc_hi, acc_lo, scale, parts[0][1].dtype, group).reshape(*lead, n)
