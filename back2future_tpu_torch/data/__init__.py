"""Host data pipeline of the port (counterpart of back2future_tpu.data):
manifests, sample loading, augmentation, batch prefetch, the compact wire
and the RoamingImages generator (`python -m
back2future_tpu_torch.data.roaming`).

Layer L5 of the reference (SURVEY.md §2.5): donkey thread pool
(data.lua), manifest datasets (donkey.lua:70-94), train/test hooks with
augmentation (donkey.lua:183-513), batch container (dataset.lua). The
exports are those of back2future_tpu/data/__init__.py:8-21. Importing
this package imports numpy only, not torch: the loader's worker
processes import it when they unpickle a dataset under spawn.
"""

from .manifest import (SampleSpec, load_manifest, load_manifest_cached,
                       load_split, write_manifest)
from .sample import SampleConfig, train_sample, test_sample, make_data
from .loader import FlowDataset, PrefetchLoader, collate, device_prefetch
from .resample import resize
from .wire import decode_batch, encode_batch

__all__ = [
    "SampleSpec", "load_manifest", "load_manifest_cached", "load_split",
    "write_manifest",
    "SampleConfig", "train_sample", "test_sample", "make_data",
    "FlowDataset", "PrefetchLoader", "collate", "device_prefetch",
    "resize", "decode_batch", "encode_batch",
]
