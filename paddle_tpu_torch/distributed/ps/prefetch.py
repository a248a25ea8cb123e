"""Sparse-pull prefetching — overlap PS round-trips with device compute;
a copy of ``paddle_tpu/distributed/ps/prefetch.py`` (pure numpy).

Analog of the reference DownpourWorker's pull/compute overlap
(downpour_worker.cc:726 pipelines PullSparse with the forward) and the
AsyncCommunicator's bounded send queue (communicator.h:253; the push
side already exists as ps/runtime.Communicator).

Design: a background thread walks the batch stream one step ahead and
issues each upcoming batch's sparse pulls, parking the rows in a
per-table staging dict keyed by the exact ids array. When the training
step's in-graph ``distributed_lookup_table`` io_callback fires, the
table's ``pull`` finds the staged rows and returns immediately — the PS
round-trip happened while the previous step was computing. A miss simply
falls through to a normal pull, so correctness never depends on the
prefetcher keeping up.

Staleness contract: a prefetched row may be older than pushes issued by
the *current* step — identical to the reference's async/half-async
semantics (and why the reference's sync CTR mode doesn't overlap either).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Callable, Dict, Iterable, Optional, Sequence

import numpy as np

from .sparse_table import REGISTRY


def _stage_key(ids: np.ndarray) -> bytes:
    a = np.ascontiguousarray(np.asarray(ids, np.int64).reshape(-1))
    return a.tobytes()


class PullPrefetcher:
    """Iterate batches with the next batch's sparse pulls in flight.

    >>> pf = PullPrefetcher(batches, {"emb_table": lambda b: b["ids"]})
    >>> for batch in pf:           # pulls for batch i+1 overlap step i
    ...     exe.run(prog, feed=batch, ...)
    """

    def __init__(self, batches: Iterable,
                 table_ids: Dict[str, Callable],
                 depth: int = 2):
        self._batches = iter(batches)
        self._table_ids = dict(table_ids)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()

    def _put(self, item) -> bool:
        """Bounded put that aborts when the consumer has left the scope
        (prevents a leaked worker blocked forever on a full queue)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self._batches:
                if self._stop.is_set():
                    return
                for tname, extract in self._table_ids.items():
                    table = REGISTRY.get(tname)
                    if table is None:
                        continue
                    ids = np.asarray(extract(batch))
                    rows = table._pull_now(ids)
                    with table._stage_lock:
                        # never stage after the consumer's finally-block
                        # deactivated the scope — a later scope must not
                        # see this (pre-push) row set
                        if self._stop.is_set() \
                                or table._stage_active <= 0:
                            return
                        table._staged.setdefault(
                            _stage_key(ids), deque()).append(rows)
                if not self._put(batch):
                    return
        except BaseException as e:      # surface in the consumer
            self._err = e
        finally:
            self._put(_DONE)

    def _tables(self):
        return [t for t in (REGISTRY.get(n) for n in self._table_ids)
                if t is not None]

    def __iter__(self):
        tables = self._tables()
        for t in tables:
            with t._stage_lock:
                t._stage_active += 1
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                if item is _DONE:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            # leaving the prefetch scope (done, break, or exception):
            # stop the worker first, then deactivate and drop leftovers
            # so no later unrelated pull can consume pre-push staged rows
            self._stop.set()
            if self._thread is not None:
                self._thread.join(timeout=5)
            for t in tables:
                with t._stage_lock:
                    t._stage_active = max(t._stage_active - 1, 0)
                    if t._stage_active == 0:
                        t._staged.clear()


_DONE = object()
