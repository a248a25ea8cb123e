"""Dataset / Sampler / DataLoader — the port's copy of
``paddle_tpu/io/dataloader.py`` (numpy batches, host threads; no torch).

Capability analog of the reference's python data stack:
- map & iterable Datasets, BatchSampler (fluid/dataloader/dataset.py,
  batch_sampler.py);
- DataLoader with background workers and bounded prefetch
  (fluid/reader.py:414 DataLoader.from_generator + multiprocess workers).

As in the JAX package, batches are plain numpy arrays for one step on
the card, so the loader uses worker THREADS with a bounded reorder
buffer: batch assembly is numpy (the GIL released in C), and the
host-to-device copy is overlapped separately by DeviceLoader
(device_loader.py, the buffered_reader.cc analog: pinned buffers and a
side stream). Each worker item passes the ``dataloader.worker`` fault
site, whose injected faults RetryPolicy replays.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Any, Callable, Iterable, List, Optional, Sequence

import numpy as np

from ..analysis.concurrency import make_lock
from ..resilience.injector import (InjectedFault, fault_point,
                                   injector_active)
from ..resilience.retry import RetryPolicy


class Dataset:
    """Map-style dataset: implement __getitem__ and __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    """Stream-style dataset: implement __iter__."""

    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise TypeError("IterableDataset has no __getitem__")

    def __len__(self):
        raise TypeError("IterableDataset has no __len__")


class TensorDataset(Dataset):
    """Wrap equal-length arrays; item i = tuple of row i of each."""

    def __init__(self, *arrays):
        if not arrays:
            raise ValueError("TensorDataset needs at least one array")
        self.arrays = [np.asarray(a) for a in arrays]
        n = len(self.arrays[0])
        if any(len(a) != n for a in self.arrays):
            raise ValueError("all arrays must share the leading dim")

    def __getitem__(self, idx):
        row = tuple(a[idx] for a in self.arrays)
        return row[0] if len(row) == 1 else row

    def __len__(self):
        return len(self.arrays[0])


class Sampler:
    def __iter__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __init__(self, data_source):
        self.n = len(data_source)

    def __iter__(self):
        return iter(range(self.n))

    def __len__(self):
        return self.n


class RandomSampler(Sampler):
    def __init__(self, data_source, seed: Optional[int] = None):
        self.n = len(data_source)
        self._rng = np.random.RandomState(seed)

    def __iter__(self):
        return iter(self._rng.permutation(self.n).tolist())

    def __len__(self):
        return self.n


class BatchSampler(Sampler):
    """Groups sampler indices into batches (fluid/dataloader/
    batch_sampler.py parity)."""

    def __init__(self, dataset=None, sampler: Optional[Sampler] = None,
                 shuffle: bool = False, batch_size: int = 1,
                 drop_last: bool = False, seed: Optional[int] = None):
        if sampler is None:
            if dataset is None:
                raise ValueError("need dataset or sampler")
            sampler = (RandomSampler(dataset, seed) if shuffle
                       else SequenceSampler(dataset))
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def __iter__(self):
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


def default_collate_fn(batch: Sequence[Any]):
    """Stack a list of samples into batch arrays (mirrors the reference's
    default_collate_fn in fluid/dataloader/collate.py)."""
    first = batch[0]
    if isinstance(first, (tuple, list)):
        return type(first)(default_collate_fn([b[i] for b in batch])
                           for i in range(len(first)))
    if isinstance(first, dict):
        return {k: default_collate_fn([b[k] for b in batch]) for k in first}
    return np.stack([np.asarray(b) for b in batch])


_STOP = object()


class _WorkerPool:
    """Background threads pulling work items, preserving order via a
    ticketed reorder buffer (samples must arrive deterministically —
    fluid reader's in-order contract)."""

    def __init__(self, fn: Callable, work_iter: Iterable, num_workers: int,
                 prefetch: int):
        self.fn = fn
        self.work = enumerate(work_iter)
        self.lock = make_lock("io._WorkerPool.lock")
        self.out: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self.reorder = {}
        self.next_emit = 0
        self.error = None
        self.done_workers = 0
        self.num_workers = num_workers
        self.cv = threading.Condition(make_lock("io._WorkerPool.cv"))
        self.threads = [threading.Thread(target=self._run, daemon=True)
                        for _ in range(num_workers)]
        for t in self.threads:
            t.start()

    def _next_work(self):
        with self.lock:
            return next(self.work, None)

    def _process(self, payload):
        """One work item through the chaos plane: the
        ``dataloader.worker`` site can inject a transient fault, which
        RetryPolicy replays (injected faults only — a REAL loader error
        still fails fast and propagates to the consumer). Zero overhead
        when no fault spec is installed."""
        if not injector_active():
            return self.fn(payload)

        def attempt():
            fault_point("dataloader.worker")
            return self.fn(payload)
        return RetryPolicy.from_flags(
            site="dataloader.worker",
            retry_on=(InjectedFault,), giveup_on=()).call(attempt)

    def _run(self):
        while True:
            item = self._next_work()
            if item is None:
                break
            tick, payload = item
            try:
                result = self._process(payload)
            except BaseException as e:  # propagate to consumer
                with self.cv:
                    self.error = e
                    self.cv.notify_all()
                return
            with self.cv:
                # bound memory: stall while the consumer is behind
                while (self.error is None
                       and tick > self.next_emit + self.num_workers
                       + self.out.maxsize):
                    self.cv.wait(timeout=0.1)
                self.reorder[tick] = result
                self.cv.notify_all()
        with self.cv:
            self.done_workers += 1
            self.cv.notify_all()

    def __iter__(self):
        while True:
            with self.cv:
                while (self.error is None
                       and self.next_emit not in self.reorder
                       and self.done_workers < self.num_workers):
                    self.cv.wait(timeout=0.1)
                if self.error is not None:
                    raise self.error
                if self.next_emit in self.reorder:
                    result = self.reorder.pop(self.next_emit)
                    self.next_emit += 1
                    self.cv.notify_all()
                else:
                    return  # drained
            yield result


class DataLoader:
    """Iterate a Dataset in collated batches with optional background
    workers.

    Parity surface: paddle.io.DataLoader(dataset, batch_size, shuffle,
    drop_last, num_workers, collate_fn, batch_sampler). ``places`` is
    accepted and ignored (device placement is DeviceLoader's job).
    """

    def __init__(self, dataset: Dataset, batch_size: Optional[int] = 1,
                 shuffle: bool = False, drop_last: bool = False,
                 num_workers: int = 0,
                 collate_fn: Optional[Callable] = None,
                 batch_sampler: Optional[BatchSampler] = None,
                 prefetch_factor: int = 2, places=None, seed=None,
                 return_list: bool = True):
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.num_workers = max(0, int(num_workers))
        self.prefetch_factor = max(1, int(prefetch_factor))
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            if batch_sampler is not None:
                raise ValueError("batch_sampler is incompatible with "
                                 "IterableDataset")
            self.batch_size = batch_size
            self.batch_sampler = None
            self.drop_last = drop_last
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
        else:
            self.batch_sampler = BatchSampler(
                dataset, shuffle=shuffle, batch_size=batch_size or 1,
                drop_last=drop_last, seed=seed)

    def _fetch(self, indices: List[int]):
        return self.collate_fn([self.dataset[i] for i in indices])

    def _iter_iterable(self):
        it = iter(self.dataset)
        if self.batch_size is None:
            yield from it
            return
        while True:
            chunk = list(itertools.islice(it, self.batch_size))
            if not chunk:
                return
            if len(chunk) < self.batch_size and self.drop_last:
                return
            yield self.collate_fn(chunk)

    def __iter__(self):
        if self._iterable:
            yield from self._iter_iterable()
            return
        if self.num_workers == 0:
            for idxs in self.batch_sampler:
                yield self._fetch(idxs)
            return
        pool = _WorkerPool(self._fetch, self.batch_sampler,
                           self.num_workers,
                           self.prefetch_factor * self.num_workers)
        yield from pool

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no length")
        return len(self.batch_sampler)
