"""Wall-clock step/data timing (counterpart of back2future_tpu/utils/timing.py).

The reference brackets each batch with torch.Timer pairs and
cutorch.synchronize (train.lua:123,193-203,498). The port's loop reads
its logs only through the metric drain, so `StepTimer` marks host time:
the wait for a batch, and the time between drains. `maybe_profile`
records a `torch.profiler` trace (host and, on a card, device activity)
and writes it into `trace_dir` as a Chrome trace, where the JAX package
used `jax.profiler`.

`span(name)` marks a layer boundary of the port (the train step's
phases, the nets' pyramid, decode and levels). While a `torch.profiler`
is running it opens `record_function(name)`, on the profiler's own
clock, so every kernel and idle gap of the device can be placed inside
it, and adds the span's host seconds and one call to an in-memory table
(`span_totals`, `reset_span_totals`). With no profiler running it
returns one shared no-op context: no RecordFunction, no table entry.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

from torch.autograd import profiler as _profiler


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


_NO_SPAN = contextlib.nullcontext()
_totals: Dict[str, Tuple[int, float]] = {}
_totals_lock = threading.Lock()


class _Span:
    """A span while a profiler runs: a RecordFunction range, and its
    host seconds added to the table on exit."""

    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._range = _profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        with _totals_lock:
            calls, total = _totals.get(self.name, (0, 0.0))
            _totals[self.name] = (calls + 1, total + seconds)
        return False


def span(name: str):
    """The context of the layer boundary `name` (module docstring)."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def span_totals() -> Dict[str, Tuple[int, float]]:
    """name -> (calls, host seconds) of the spans closed while a profiler
    ran, since the last `reset_span_totals`."""
    with _totals_lock:
        return dict(_totals)


def reset_span_totals() -> None:
    with _totals_lock:
        _totals.clear()
