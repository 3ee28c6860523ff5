"""Carrying state across from the JAX package.

This system has no weights: its state is the scan poses (N, 6)
`[aa_lw, t_lw]` and the per-scan feature batch (the `ScanFeatures` fields of
`panovlm_tpu/sensors/velodyne.py`, with a leading scan axis). With these two
functions a test hands the JAX package's extracted features and poses, as
numpy, to the port, so both packages run association and the solve on
identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

# ScanFeatures field names (panovlm_tpu/sensors/velodyne.py ScanFeatures)
FEATURE_FIELDS = (
    "sharp", "sharp_mask", "less_sharp", "less_sharp_mask", "less_sharp_row",
    "point_to_segment", "flat", "flat_mask", "flat_ground", "flat_row",
    "less_flat", "less_flat_mask", "less_flat_ground", "less_flat_row",
    "line_points", "line_dirs", "line_endpoints", "line_mask")


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return torch.from_numpy(a.copy()).to(device)
    if np.issubdtype(a.dtype, np.integer):
        return torch.from_numpy(a.astype(np.int32)).to(device)
    return torch.from_numpy(a.astype(np.float32)).to(device)


def features_from_numpy(batch: dict, device="cpu") -> dict[str, torch.Tensor]:
    """Stacked per-scan feature dict (numpy or array-likes, leading scan
    axis) -> dict of tensors: float32 coordinates, bool masks, int32 ids."""
    missing = [k for k in FEATURE_FIELDS if k not in batch]
    if missing:
        raise KeyError(f"feature batch lacks fields {missing}")
    return {k: _to_tensor(batch[k], device) for k in FEATURE_FIELDS}


def poses_from_numpy(poses, device="cpu") -> torch.Tensor:
    """(N, 6) [aa_lw, t_lw] poses -> float32 tensor."""
    p = np.asarray(poses, np.float32)
    if p.ndim != 2 or p.shape[1] != 6:
        raise ValueError(f"poses must be (N, 6), got {p.shape}")
    return torch.from_numpy(p.copy()).to(device)
