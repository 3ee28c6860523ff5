"""Processes across devices and hosts — the port of
`panovlm_tpu/parallel/multihost.py`.

The JAX package has two tiers: the devices of one process (the "data" mesh
axis, ICI) and processes across hosts (DCN), joined by
`jax.distributed.initialize`. With torch.distributed one process drives one
device, so ranks cover both tiers: `python -m torch.distributed.run
--nproc-per-node N` starts N ranks on one host (more hosts with
`--nnodes`), and every stage splits its work over all of them.

  * `initialize_distributed(device)`: `init_process_group` from torchrun's
    environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT),
    NCCL for `cuda` with the rank on `cuda:LOCAL_RANK`, gloo for `cpu`; a
    no-op without that environment or at WORLD_SIZE 1.
  * `make_hybrid_mesh(device_type)`: a (hosts, ranks per host) DeviceMesh
    with the JAX package's axis names ("frame", "data").
  * `process_slice(n)`: the balanced contiguous split of n frames, pairs or
    scans over the ranks.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .sharding import DATA_AXIS

FRAME_AXIS = "frame"   # across hosts: per-frame fan-out only

# how long a rank waits for the others at initialisation and in a
# collective before it raises (torch.distributed's own default for gloo)
TIMEOUT = datetime.timedelta(minutes=30)


def initialize_distributed(device="cuda", timeout: datetime.timedelta = TIMEOUT) -> bool:
    """`init_process_group` from torchrun's environment contract. Returns
    True iff the process runs as one rank of several after the call, False
    (and does nothing) when WORLD_SIZE is missing or 1. The backend follows
    the device asked for: NCCL for `cuda` (the rank's card, `cuda:LOCAL_RANK`,
    becomes the current device), gloo for `cpu`. Nothing switches backend
    or device when that fails: an NCCL error, two ranks on one card for
    one, is raised. Idempotent."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    from ..device import resolve
    rank = int(os.environ["RANK"])
    kind = torch.device(device).type
    if kind == "cuda":
        dev = resolve(f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}")
        dist.init_process_group("nccl", init_method="env://", rank=rank,
                                world_size=world, timeout=timeout, device_id=dev)
    elif kind == "cpu":
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=world, timeout=timeout)
    else:
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return True


def make_hybrid_mesh(device_type: str = "cpu"):
    """(hosts, ranks per host) DeviceMesh over the initialised default
    group, axes (FRAME_AXIS, DATA_AXIS): solver data splits over "data"
    only, frame batches over "frame" only. On one host it is (1, world)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"world size {world} is not a multiple of "
                         f"LOCAL_WORLD_SIZE {per_host}")
    return init_device_mesh(device_type, (world // per_host, per_host),
                            mesh_dim_names=(FRAME_AXIS, DATA_AXIS))


def process_slice(n_items: int, rank: int | None = None, world: int | None = None) -> slice:
    """Contiguous chunk of an n_items frame / pair / scan list for one rank:
    the first n_items % world ranks get one item more. Every rank computes
    the same partition without communicating. rank and world default to
    this process's in the initialised default group (0 and 1 without
    one)."""
    if rank is None or world is None:
        on = dist.is_initialized()
        rank = (dist.get_rank() if on else 0) if rank is None else rank
        world = (dist.get_world_size() if on else 1) if world is None else world
    base, rem = divmod(n_items, world)
    start = rank * base + min(rank, rem)
    return slice(start, start + base + (1 if rank < rem else 0))
