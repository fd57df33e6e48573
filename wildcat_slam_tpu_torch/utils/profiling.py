"""Profiling instrumentation of the port.

Counterpart of ``wildcat_slam_tpu/utils/profiling.py``:

- :class:`StageTimer` -- wall-clock stage timers that wait for the card
  before a stage ends (``torch.cuda.synchronize``, as ``jax.block_until_ready``
  waits), for per-stage breakdowns of the host loop;
- :func:`trace` -- a context manager around ``torch.profiler`` (CPU, and
  CUDA where a card is visible) that writes a Chrome trace into a directory.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulates wall time per named stage. With ``block_on`` (a tensor on
    a card) the stage waits for that card to finish its queued work before
    it ends, so its time is the work's."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Optional[torch.Tensor] = None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None and block_on.device.type == "cuda":
                torch.cuda.synchronize(block_on.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            c, tot = self.counts[name], self.totals[name]
            lines.append(f"{name:<28} total {tot * 1e3:9.1f} ms  n={c:<5d} mean "
                         f"{tot / c * 1e3:8.2f} ms")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` and write its Chrome trace to
    ``logdir/trace.json`` (``chrome://tracing`` or Perfetto open it):
    ``with trace('/tmp/profile'): run()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
