"""Shared utilities of the port: logging and timing (counterpart of
back2future_tpu.utils; its compile cache is JAX-only and not ported)."""

from .logger import SymbolLogger, TeeLogger
from .timing import StepTimer, maybe_profile

__all__ = ["SymbolLogger", "TeeLogger", "StepTimer", "maybe_profile"]
