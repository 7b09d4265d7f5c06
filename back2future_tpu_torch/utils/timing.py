"""Wall-clock step/data timing (counterpart of back2future_tpu/utils/timing.py).

The reference brackets each batch with torch.Timer pairs and
cutorch.synchronize (train.lua:123,193-203,498). The port's loop reads
its logs only through the metric drain, so `StepTimer` marks host time:
the wait for a batch, and the time between drains. `maybe_profile`
records a `torch.profiler` trace (host and, on a card, device activity)
and writes it into `trace_dir` as a Chrome trace, where the JAX package
used `jax.profiler`.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Optional


class StepTimer:
    """Tracks data-loading time and step time per batch."""

    def __init__(self):
        self._t_mark = time.perf_counter()
        self.data_time = 0.0
        self.step_time = 0.0

    def data_loaded(self):
        now = time.perf_counter()
        self.data_time = now - self._t_mark
        self._t_mark = now

    def step_done(self):
        now = time.perf_counter()
        self.step_time = now - self._t_mark
        self._t_mark = now


@contextlib.contextmanager
def maybe_profile(trace_dir: Optional[str]):
    """torch.profiler capture of the block when a directory is given: the
    CPU activity, and the CUDA activity where a card is present, written
    to `<trace_dir>/trace.json` (chrome://tracing, Perfetto)."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))
