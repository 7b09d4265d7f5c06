"""Run options of the port: the JAX package's `Options`
(back2future_tpu/config.py, the reference's opts.lua with its derived
options), which is framework-free and reused by import, so the port's
callers need not reach into the JAX package for it."""

from back2future_tpu.config import Options  # noqa: F401  (re-exported)

__all__ = ["Options"]
