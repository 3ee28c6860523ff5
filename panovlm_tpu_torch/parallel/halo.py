"""Time-axis trajectory sharding: the ring halo and windowed association —
the port of `panovlm_tpu/parallel/halo.py`.

With the scan axis split over the ranks (`multihost.process_slice`), each
rank owns a contiguous block of scans. The temporal pairs (g, g + d),
d = 1..window, of its scans reach at most `window` scans into the next
rank's block, so each rank sends the first `window` scans of its block to
the rank on its left and receives its right neighbour's: one exchange of
the window-sized boundary block (`dist.batch_isend_irecv`), whatever the
trajectory's length. The ring wraps; pairs that reach past the last scan
are masked. The association of every pair then runs on this rank's scans
and the halo alone, through the port's pair functions and so the KNN
kernels (K1, K2); each pair's rows are those of `associate_all_pairs` on
the same pair.

The odometry stage does not take this path: every rank holds every scan,
so it splits a round's pair list into chunks over the ranks instead
(`models/lidar_odometry.py`), with no exchange and no pair associated
twice.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .multihost import process_slice


def ring_halo_right(x, window: int, group=None):
    """This rank's block with its right ring neighbour's first `window`
    rows appended: (n_loc, ...) -> (n_loc + window, ...), for a tensor or
    a dict of tensors. The last rank receives rank 0's head; at world size
    1 (or without a group) the halo is the block's own head, with no send.
    Every rank's block must hold at least `window` rows."""
    single = not isinstance(x, dict)
    xs = {"x": x} if single else x
    n_loc = {v.shape[0] for v in xs.values()}
    if len(n_loc) != 1 or min(n_loc) < window:
        raise ValueError(f"ring_halo_right: blocks of {sorted(n_loc)} rows, window {window}: "
                         "every rank needs at least `window` rows")
    if group is None or group.world == 1:
        out = {k: torch.cat([v, v[:window]]) for k, v in xs.items()}
    else:
        left, right = (group.rank - 1) % group.world, (group.rank + 1) % group.world
        ops, recv = [], {}
        for k in sorted(xs):   # the same order on every rank: sends match receives
            head = group.to_comm(xs[k][:window])
            recv[k] = torch.empty_like(head)
            ops.append(dist.P2POp(dist.isend, head, left))
            ops.append(dist.P2POp(dist.irecv, recv[k], right))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        out = {k: torch.cat([v, recv[k].to(v.device)]) for k, v in xs.items()}
    return out["x"] if single else out


def _windowed_pairs(n_loc: int, g0: int, window: int, n_scans: int, bidirectional: bool,
                   device=None):
    """The temporal pairs of a block of n_loc scans starting at global scan
    g0: local roles (lr, ln) into block + halo, global (pair_r, pair_n)
    and pair_valid (both scans below n_scans: wrapped and padded pairs
    masked). Forward pairs (g, g + d), d = 1..window, per scan; with
    `bidirectional` the reversed roles (g + d, g) follow the forward block
    (association is asymmetric, LidarFeatureAssociate.cpp:19-111)."""
    li = torch.arange(n_loc, device=device).repeat_interleave(window)
    dd = torch.arange(1, window + 1, device=device).repeat(n_loc)
    lr, ln = li, li + dd
    if bidirectional:
        lr, ln = torch.cat([li, li + dd]), torch.cat([li + dd, li])
    pair_r, pair_n = g0 + lr, g0 + ln
    return lr, ln, pair_r, pair_n, torch.maximum(pair_r, pair_n) < n_scans


def associate_windowed_sharded(batch_local, poses, n_scans: int, window: int, group=None,
                               bidirectional: bool = False):
    """Association of every temporal pair (g, g + d), d = 1..window, of
    this rank's scans. batch_local: this rank's block of the stacked
    per-scan feature dict (`sharding.shard_leading_axis`); poses (N, 6)
    replicated. Returns (assoc, pair_r, pair_n, pair_valid) for this rank's
    n_loc * window pairs (twice that with `bidirectional`), in the JAX
    function's per-shard order; masks are False on invalid pairs. Over the
    ranks in rank order the pairs are the JAX function's list."""
    from ..models import association
    dev = poses.device
    n_loc = next(iter(batch_local.values())).shape[0]
    g0 = process_slice(n_scans, *((group.rank, group.world) if group else (0, 1))).start
    halo = ring_halo_right(batch_local, window, group)
    lr, ln, pair_r, pair_n, pair_valid = _windowed_pairs(n_loc, g0, window, n_scans,
                                                        bidirectional, dev)
    # pose rows of wrapped pairs are clipped; their outputs are masked out
    rows = torch.clamp(g0 + torch.arange(n_loc + window, device=dev), max=poses.shape[0] - 1)
    assoc = association.associate_all_pairs(halo, poses[rows], lr, ln)
    for fam in assoc.values():
        fam["mask"] = fam["mask"] & pair_valid[:, None]
    return assoc, pair_r, pair_n, pair_valid
