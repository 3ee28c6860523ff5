"""Device selection and float32 precision policy.

The JAX package pins every pose and geometry product to
`Precision.HIGHEST`; on Hopper the same trap is TF32, which keeps about three
decimal digits. `resolve` turns TF32 off for matmuls and cuDNN before any work
runs, and never falls back to the CPU when CUDA is asked for. It also
calls torch's CPU math functions once on one value (`_warm_cpu_math`).
"""

from __future__ import annotations

import torch


def _warm_cpu_math():
    """MKL's vector math, behind torch's CPU sin, cos, exp, log and the
    like, sets itself up at its first call, and not safely for two intra-op
    threads at once: in about one fresh SfM stage run in seven on a 2-thread
    CPU, the first torch.cos gave one thread's block of 2048 values up to
    ~2500 ulps off (ROADMAP F11). One call on one value, before any
    parallel work, sets it up."""
    one = torch.zeros(1)
    for f in (torch.cos, torch.sin, torch.tan, torch.exp, torch.log, torch.atan,
              torch.sqrt, torch.tanh):
        f(one)


def resolve(device) -> torch.device:
    """`cuda` or `cpu` (a name or a torch.device) -> torch.device, with full
    float32 for matmuls and convolutions (no TF32) and the CPU math set up.
    Every stage function and pair-surgery verb calls it, so a library caller
    gets what the CLI gets. Raises if CUDA is asked for and no card is
    visible."""
    kind = device.type if isinstance(device, torch.device) else device
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _warm_cpu_math()
    return torch.device(device)
