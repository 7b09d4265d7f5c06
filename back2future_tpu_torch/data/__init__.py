"""Data path of the port (counterpart of back2future_tpu.data).

Ported: the device-side decode of the compact wire (`decode_batch`), and
the numpy helpers the inference API needs (`augment.color_normalize`,
`resample.resize`). The host training pipeline (manifests, loading,
augmentation, prefetch) is not ported yet.
"""

from .wire import decode_batch

__all__ = ["decode_batch"]
