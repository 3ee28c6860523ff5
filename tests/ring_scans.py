"""Seeded VLP-16 firing columns for the ring-repair tests (ReOrderVLP2):
tests/test_torch_odometry_options.py holds the port against the JAX
package on them, tests/test_torch_options_cuda.py the card against the CPU,
and chip_smoke.py's phase 14 (c) repairs the probe on the card."""

import numpy as np

# the VLP-16 firing order: within one firing column the rings arrive as
# 0, 8, 1, 9, ..., 7, 15 (Velodyne.cpp:246-254)
ORDER_TO_RING = [0, 8, 1, 9, 2, 10, 3, 11, 4, 12, 5, 13, 6, 14, 7, 15]


def firing_column(az, rings, jitter_deg=None):
    """Points of one firing column at azimuth az, in the given ring order
    (ring r at elevation -15 + 2r degrees), camera axes; jitter_deg moves
    each point's elevation by that many degrees."""
    el_deg = np.asarray(rings, np.float64) * 2.0 - 15.0
    if jitter_deg is not None:
        el_deg = el_deg + jitter_deg
    els = np.radians(el_deg)
    h = np.cos(els)
    return np.stack([h * np.sin(az), -np.sin(els), h * np.cos(az)], 1).astype(np.float32)


def probe():
    """The firing-column probe of tests/test_velodyne.py: five columns,
    the third with its position-10 return (ring 5) measured at ring 6's
    elevation and position 11 (ring 13) missing. Returns (points, the
    rings the repair must give)."""
    cols, expect = [], []
    for k in range(5):
        rings = ORDER_TO_RING
        if k == 2:
            rings = ORDER_TO_RING[:10] + [6] + ORDER_TO_RING[12:]
            expect += ORDER_TO_RING[:10] + [5] + ORDER_TO_RING[12:]
        else:
            expect += ORDER_TO_RING
        cols.append(firing_column(0.01 + 0.3 * k, rings))
    return np.concatenate(cols), np.asarray(expect)


def jittered_scan(seed, n_cols=700, points_per_col=16, share=0.06):
    """Firing columns in packet order with a seeded share of the returns
    moved 1.1-1.4 degrees up or down, onto a neighbouring ring: the
    conflicts the repair is for, some columns with two."""
    rng = np.random.default_rng(seed)
    cols = []
    for k in range(n_cols):
        rings = ORDER_TO_RING[:points_per_col]
        jit = np.where(rng.random(len(rings)) < share,
                       rng.choice([-1.0, 1.0], len(rings)) * rng.uniform(1.1, 1.4, len(rings)),
                       0.0)
        keep = rng.random(len(rings)) > 0.05
        cols.append(firing_column(2 * np.pi * k / n_cols, rings, jit)[keep])
    return np.concatenate(cols)
