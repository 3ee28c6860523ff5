"""Multi-device and multi-host runs over torch.distributed — the port of
`panovlm_tpu/parallel/`: one process per device (a rank), NCCL between CUDA
devices and gloo on the CPU. `sharding` holds the group and the splits of
the data, `halo` the scan-sharded temporal association, `multihost` the
process-group set-up from torchrun's environment and the per-rank frame
split."""

from .sharding import (DataGroup, make_mesh, pad_leading_to_multiple,  # noqa: F401
                       replicated, shard_blocks, shard_leading_axis)
