"""Host-memory budget assertion — fail in seconds, not at hour two — and
the chunk size of batched device work.

The port's copy of `assert_host_budget` from panovlm_tpu/utils/membudget.py.
A stage declares its dominant host arrays up front; if the plan alone
exceeds the machine, it raises at once with the itemized plan, so the
operator lowers the resolution or the frame count instead of meeting the
limit mid-stage.
"""

from __future__ import annotations

import logging
import os

import numpy as np

log = logging.getLogger("panovlm")


def host_total_bytes() -> int:
    try:
        return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        return 1 << 62


def assert_host_budget(stage: str, plan: dict, limit_frac: float = 0.85,
                       slack: float = 1.5):
    """plan: {name: (shape tuple, dtype)}. Logs the itemized plan and
    returns its bytes. Raises MemoryError when the plan alone exceeds
    limit_frac of physical RAM; warns when slack * plan does (transient
    copies). PANOVLM_IGNORE_HOST_BUDGET=1 downgrades the error to a
    warning."""
    items = []
    total = 0
    for name, (shape, dtype) in plan.items():
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        items.append((name, shape, nbytes))
        total += nbytes
    avail = host_total_bytes()
    lines = ", ".join(f"{n} {tuple(s)} = {b / 2**30:.2f} GB"
                      for n, s, b in items)
    log.info("host budget [%s]: %.2f GB planned (x%.1f slack) of %.1f GB "
             "RAM — %s", stage, total / 2**30, slack, avail / 2**30, lines)
    override = os.environ.get("PANOVLM_IGNORE_HOST_BUDGET") == "1"
    if total > limit_frac * avail and not override:
        raise MemoryError(
            f"stage {stage}: planned host arrays need {total / 2**30:.1f} "
            f"GB but only {limit_frac * avail / 2**30:.1f} GB of RAM is "
            f"budgeted. Itemized plan: {lines}. Reduce the working "
            f"resolution (config scale), the frame count, run on a larger "
            f"host, or set PANOVLM_IGNORE_HOST_BUDGET=1 to proceed anyway.")
    if slack * total > limit_frac * avail:
        log.warning(
            "host budget [%s]: plan fits RAM but x%.1f transient slack "
            "does not (%.1f GB > %.1f GB) — the stage may OOM under "
            "transient copies", stage, slack, slack * total / 2**30,
            limit_frac * avail / 2**30)
    return total


def device_chunk(item_bytes: int, device, frac: float = 0.25,
                 max_items: int = 1 << 16) -> int:
    """How many items of `item_bytes` temporaries fit in `frac` of the free
    memory of `device` (of physical RAM on the CPU); at least 1."""
    import torch
    device = torch.device(device)
    if device.type == "cuda":
        free = torch.cuda.mem_get_info(device)[0]
    else:
        free = host_total_bytes()
    return int(max(1, min(max_items, frac * free // max(item_bytes, 1))))
