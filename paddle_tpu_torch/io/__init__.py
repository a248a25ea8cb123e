"""paddle_tpu_torch.io — the data pipeline, the counterpart of
``paddle_tpu/io``: Dataset/Sampler/DataLoader (numpy, host threads) and
the prefetch onto the card (:class:`DeviceLoader`).

Analog of python/paddle/fluid/reader.py:414 (DataLoader.from_generator),
python/paddle/fluid/dataloader/ (Dataset/BatchSampler/fetcher) and the
C++ double-buffer host->device pipeline
(operators/reader/buffered_reader.cc).
"""

from .dataloader import (BatchSampler, DataLoader, Dataset, IterableDataset,
                         RandomSampler, Sampler, SequenceSampler,
                         TensorDataset, default_collate_fn)
from .device_loader import DeviceLoader

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "Sampler",
    "SequenceSampler", "RandomSampler", "BatchSampler", "DataLoader",
    "DeviceLoader", "default_collate_fn",
]
