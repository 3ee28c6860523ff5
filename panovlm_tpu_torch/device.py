"""Device selection and float32 precision policy.

The JAX package pins every pose and geometry product to
`Precision.HIGHEST`; on Hopper the same trap is TF32, which keeps about three
decimal digits. `resolve` turns TF32 off for matmuls and cuDNN before any work
runs, and never falls back to the CPU when CUDA is asked for.
"""

from __future__ import annotations

import torch


def resolve(name: str) -> torch.device:
    """`cuda` or `cpu` -> torch.device, with full float32 for matmuls and
    convolutions (no TF32). Raises if `cuda` is asked for and no card is
    visible."""
    if name not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device(name)
