"""Per-phase wall-clock accounting (TimeReport, reference main.cpp:680-697).

Named phases accumulate seconds; a report prints each phase and the total.
The port's copy of panovlm_tpu/utils/timing.py. PyTorch returns before the
card has finished, so a phase that ran CUDA work synchronises the device
before it reads the clock: the phase times are device-inclusive.
"""

from __future__ import annotations

import contextlib
import time

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class TimeReport:
    def __init__(self):
        self.time_spent: dict[str, float] = {}
        self._depth = 0
        self._top_level: set[str] = set()

    @contextlib.contextmanager
    def phase(self, name: str):
        if self._depth == 0:
            self._top_level.add(name)
        self._depth += 1
        _sync()
        t0 = time.time()
        try:
            yield
        finally:
            _sync()
            self._depth -= 1
            self.time_spent[name] = self.time_spent.get(name, 0.0) + time.time() - t0

    def report(self) -> str:
        lines = ["===== Time Report ====="]
        # nested phases print but only top-level ones sum into the total
        # (the CLI wraps the whole stage in one phase around the stage's own
        # sub-phases; counting both would double the total)
        total = 0.0
        for name, sec in self.time_spent.items():
            lines.append(f"{name:40s} {sec:10.2f} s")
            if name in self._top_level or not self._top_level:
                total += sec
        lines.append(f"{'total':40s} {total:10.2f} s")
        return "\n".join(lines)
