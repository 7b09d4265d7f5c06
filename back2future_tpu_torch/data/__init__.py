"""Device side of the data path (counterpart of back2future_tpu.data).

The host pipeline (manifests, loading, augmentation, prefetch) is
framework-free and is reused from `back2future_tpu.data` by import; only
what runs on the device is ported here.
"""

from .wire import decode_batch

__all__ = ["decode_batch"]
