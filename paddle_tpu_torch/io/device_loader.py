"""DeviceLoader — host-to-card prefetch, the counterpart of
``paddle_tpu/io/device_loader.py`` (the reference's C++ BufferedReader,
operators/reader/buffered_reader.cc): while the card computes on batch
N, batch N+1 is already on its way.

A producer thread walks the loader, stages each leaf of a batch (a dict,
tuple or list of numpy arrays, nested, or one array) in pinned host
memory and copies it to the card with ``non_blocking`` on a side stream
of its own, keeping ``depth`` batches in flight. An event recorded on
the side stream after a batch's copies travels with it: the consumer's
stream waits on that event before it is handed the batch, and each of
the batch's tensors is ``record_stream``-ed on the consumer's stream, so
the caching allocator does not hand its memory out again while the
consumer's work on it is queued.

``device=None`` means the card (and raises without one, as every entry
point of the port does); with ``device="cpu"`` batches pass through
unchanged. The reference's ``mesh`` / ``spec`` (a batch sharded over a
mesh axis) wait for ROADMAP A5.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable

import numpy as np
import torch

from ..device import resolve_device

_STOP = object()


def _tree_map(fn, batch):
    if isinstance(batch, dict):
        return {k: _tree_map(fn, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(_tree_map(fn, v) for v in batch)
    return fn(batch)


def _leaves(batch):
    if isinstance(batch, dict):
        for v in batch.values():
            yield from _leaves(v)
    elif isinstance(batch, (tuple, list)):
        for v in batch:
            yield from _leaves(v)
    else:
        yield batch


class DeviceLoader:
    def __init__(self, loader: Iterable, depth: int = 2, device=None,
                 mesh=None, spec=None):
        """``loader`` yields batches of numpy arrays (dicts, tuples and
        lists of them, nested). Batches land on ``device`` (None: the
        card)."""
        if mesh is not None or spec is not None:
            raise NotImplementedError(
                "DeviceLoader(mesh=, spec=): a batch sharded over a mesh "
                "waits for ROADMAP A5 (the port runs one card)")
        self.loader = loader
        self.depth = max(1, int(depth))
        self.device = resolve_device(device)
        self._stream = None

    def _put(self, batch):
        """``batch`` copied to the card on the side stream: (tree, event)."""
        dev = self.device

        def put(a):
            t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
                np.ascontiguousarray(np.asarray(a)))
            return t.pin_memory().to(dev, non_blocking=True)

        with torch.cuda.stream(self._stream):
            tree = _tree_map(put, batch)
            event = torch.cuda.Event()
            event.record(self._stream)
        return tree, event

    def __iter__(self):
        if self.device.type != "cuda":
            yield from self.loader
            return
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        err: list = []
        stop = threading.Event()

        def put(item) -> bool:
            # a bounded put that gives up when the consumer walked away:
            # an early `break` must not pin the producer (and `depth`
            # batches of card memory) forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                torch.cuda.set_device(self.device)
                for batch in self.loader:
                    if not put(self._put(batch)):
                        return
            except BaseException as e:
                err.append(e)
            finally:
                put(_STOP)

        t = threading.Thread(target=producer, daemon=True,
                             name="DeviceLoader.producer")
        t.start()
        try:
            while True:
                item = q.get()
                if item is _STOP:
                    if err:
                        raise err[0]
                    return
                tree, event = item
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(event)
                for leaf in _leaves(tree):
                    leaf.record_stream(consumer)
                yield tree
        finally:
            stop.set()
            while not q.empty():      # release the buffered card batches
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)
