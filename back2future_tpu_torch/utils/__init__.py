"""Shared utilities of the port: logging and timing (counterpart of
back2future_tpu.utils; its compile cache is JAX-only and not ported),
and `span`, the port's layer boundaries on the profiler's clock with
their host-time table (`span_totals`, `reset_span_totals`)."""

from .logger import SymbolLogger, TeeLogger
from .timing import StepTimer, maybe_profile, reset_span_totals, span, span_totals

__all__ = ["SymbolLogger", "TeeLogger", "StepTimer", "maybe_profile", "span", "span_totals",
           "reset_span_totals"]
