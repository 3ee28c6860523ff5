"""Ranks and the split of a stage's data over them — the port of
`panovlm_tpu/parallel/sharding.py`.

The JAX package splits work over a 1-D device mesh (axis "data") and lets
XLA insert the psums of the normal equations. Here one process drives one
device (a rank) of a `torch.distributed` process group: NCCL between CUDA
devices, gloo on the CPU. A `DataGroup` names the group, this rank, the
world size and the rank's device; `None` in its place means one rank and
no communication, as the JAX package's `mesh=None`.

  * residual observations, scan pairs and frames are split into
    contiguous slices, `multihost.process_slice`'s balanced split;
  * parameters (poses, structure) are replicated: every rank holds them
    whole and updates them alike, from sums that every rank gets whole
    (`ops/exact.index_sum(..., group)`: fixed point, so a sum has the same
    bits however its terms are split).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class DataGroup:
    """One rank's view of the default process group: `rank`, `world` and
    `device`, the rank's compute device. Collectives run on the backend's
    device (the rank's card for NCCL, the CPU for gloo) and return on the
    device of their input."""

    def __init__(self, device):
        if not dist.is_initialized():
            raise RuntimeError("DataGroup: torch.distributed is not initialised "
                               "(multihost.initialize_distributed, or "
                               "init_process_group)")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.backend = dist.get_backend()
        self.comm_device = device if self.backend == "nccl" else torch.device("cpu")

    def to_comm(self, t):
        """A contiguous copy of t on the backend's device."""
        return t.to(self.comm_device, copy=True).contiguous()

    def all_reduce(self, t, op: str):
        """A copy of t reduced over the ranks ("sum" or "max")."""
        c = self.to_comm(t)
        dist.all_reduce(c, op=_OPS[op])
        return c.to(t.device)

    def broadcast(self, t, src: int = 0):
        """Rank src's t, on every rank (t gives shape and dtype elsewhere)."""
        c = self.to_comm(t)
        dist.broadcast(c, src=src)
        return c.to(t.device)

    def all_gather_object(self, obj):
        """Every rank's obj, in rank order (picklable host objects)."""
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def barrier(self):
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.comm_device.index])
        else:
            dist.barrier()


def make_mesh(device) -> DataGroup | None:
    """The data group over the initialised default process group, or None
    when torch.distributed is not initialised: one rank. A group of world
    size 1 stays a group, so its solves take the group path (exact costs),
    as they do at every other world size."""
    if not dist.is_initialized():
        return None
    return DataGroup(device)


def _slice(n: int, group: DataGroup) -> slice:
    from .multihost import process_slice
    return process_slice(n, group.rank, group.world)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def shard_leading_axis(tree, group: DataGroup | None):
    """This rank's contiguous slice (`process_slice`'s) of the leading axis
    of every tensor or array in a dict / list / tuple tree; the whole tree
    without a group."""
    if group is None:
        return tree
    n = {x.shape[0] for x in _leaves(tree)}
    if len(n) != 1:
        raise ValueError(f"leading axes differ: {sorted(n)}")
    s = _slice(n.pop(), group)
    return _map(tree, lambda x: x[s])


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def replicated(tree, group: DataGroup | None):
    """Every tensor of the tree as rank 0 holds it, on every rank: the
    parameters every rank updates alike start from the same bits."""
    if group is None:
        return tree
    return _map(tree, lambda x: group.broadcast(x, 0))


ROW_CHUNKS = 4   # chunks per residual block (`shard_blocks`)


def shard_blocks(blocks, group: DataGroup | None):
    """Each rank's share of every ResidualBlock's observation rows (indices,
    data, weight, mask). A block is cut into at most ROW_CHUNKS chunks of
    whole runs, and each rank takes the contiguous chunks of
    `process_slice`'s split of them: every row lives on exactly one rank,
    in the same chunk at every world size, so that `solve_lm`, which
    evaluates a block chunk by chunk, gives it the same bits however the
    ranks share the chunks (at most ROW_CHUNKS ranks get rows). Masked-out
    rows add nothing wherever they lie. A block whose rows are no whole
    number of runs (where the solver sums no runs) loses its runs on every
    rank alike. Without a group every block is whole, cut into the same
    chunks. Parameter groups stay replicated."""
    out = []
    for b in blocks:
        n = b.mask.shape[0]
        rl = b.run_length if b.run_length > 1 and n % b.run_length == 0 else 1
        c = max(rl, -(-n // (ROW_CHUNKS * rl)) * rl)   # rows per chunk
        if group is None:
            out.append(dataclasses.replace(b, chunk=c, run_length=rl))
            continue
        k = _slice(-(-n // c), group)
        s = slice(k.start * c, min(k.stop * c, n))
        out.append(dataclasses.replace(
            b, indices=tuple(i[s] for i in b.indices), data=tuple(d[s] for d in b.data),
            weight=b.weight[s], mask=b.mask[s], chunk=c, run_length=rl))
    return tuple(out)


def pad_leading_to_multiple(tree, multiple: int):
    """Pad every leading axis with zeros (False) to a multiple of
    `multiple`; masks in the tree must already encode validity."""
    def pad(x):
        n = x.shape[0]
        target = -(-n // multiple) * multiple
        if target == n:
            return x
        if torch.is_tensor(x):
            return torch.cat([x, x.new_zeros((target - n, *x.shape[1:]))])
        x = np.asarray(x)
        return np.pad(x, [(0, target - n)] + [(0, 0)] * (x.ndim - 1))
    return _map(tree, pad)
