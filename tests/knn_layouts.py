"""Inputs of the KNN kernels laid out as the odometry stage lays them out,
for the CPU parity tests and the card-only kernel tests (numpy only: the
card's machine has no JAX).

Queries come as `sensors/velodyne.picks_to_buffer` makes them: picks
round-major, so consecutive queries cycle over the rings; a fifth of the
picks invalid, interleaved; the buffer padded to its cap with a masked
tail (at CAP_FLAT = 512 at most 384 picks). Masked queries hold zeros and
ring -1. Targets come as `gather_masked` makes them: the valid points
first, in row-major order of the range image (so ordered by ring), then a
zero-filled masked tail with ring -1.
"""

import numpy as np


def stage_layout(seed, B, Q, T, n_rings=16, pick_share=0.75, min_valid=None):
    """(q, q_mask, t, t_mask, q_row, t_row) numpy arrays: float32 points in
    (B, Q, 3) and (B, T, 3), bool masks, int32 ring ids."""
    rng = np.random.default_rng(seed)
    n_pick = int(Q * pick_share)
    q = rng.normal(size=(B, Q, 3)).astype(np.float32)
    qm = (np.arange(Q) < n_pick)[None] & (rng.random((B, Q)) > 0.2)
    qr = np.tile((np.arange(Q) % n_rings).astype(np.int32), (B, 1))
    t = rng.normal(size=(B, T, 3)).astype(np.float32)
    n_valid = rng.integers(T // 2 if min_valid is None else min_valid, T + 1, B)
    tm = np.arange(T)[None] < n_valid[:, None]
    tr = np.sort(rng.integers(0, n_rings, (B, T)), axis=1).astype(np.int32)
    q[~qm], qr[~qm] = 0.0, -1
    t[~tm], tr[~tm] = 0.0, -1
    return q, qm, t, tm, qr, tr
