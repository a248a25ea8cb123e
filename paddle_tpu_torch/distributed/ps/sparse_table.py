"""Host-resident sparse parameter tables — a copy of
``paddle_tpu/distributed/ps/sparse_table.py`` (pure numpy).

Analog of the reference's large-scale KV store
(operators/distributed/large_scale_kv.h:160,255 SparseVariable/ValueBlock)
serving distributed_lookup_table. Rows live in host RAM (the tables are
the tier that never fits on the card); the device sees only the gathered
dense rows per batch. A table's rows are drawn from
``RandomState(hash(name) % 2**31)``, which ``PYTHONHASHSEED`` salts per
process: in one process both packages draw the same rows for a name,
across processes they differ (ROADMAP C, a fault of the reference the
port keeps).
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ...analysis.concurrency import make_lock


class SparseTable:
    """One embedding table, sharded by id hash into blocks (ValueBlock
    analog) with per-block locks for concurrent pull/push."""

    def __init__(self, name: str, value_dim: int, shard_num: int = 8,
                 initializer=None, optimizer: str = "sgd",
                 lr: float = 0.01, init: str = "random"):
        if initializer is None and init == "zeros":
            initializer = lambda rng, dim: np.zeros(dim, np.float32)
        self.name = name
        self.value_dim = value_dim
        self.shard_num = shard_num
        self._shards: List[Dict[int, np.ndarray]] = [
            {} for _ in range(shard_num)]
        self._locks = [make_lock(f"SparseTable._locks[{i}]")
                       for i in range(shard_num)]
        self._init = initializer or (
            lambda rng, dim: (rng.standard_normal(dim) * 0.01).astype(
                np.float32))
        self._rng = np.random.RandomState(hash(name) % 2**31)
        self.optimizer = optimizer
        self.lr = lr
        # per-row optimizer state (adagrad accumulators)
        self._accum: List[Dict[int, np.ndarray]] = [
            {} for _ in range(shard_num)]
        # rows staged by a PullPrefetcher (ps/prefetch.py), keyed by the
        # exact ids payload, FIFO per key: each staged row set is
        # consumed exactly ONCE, in stage order, so duplicate consecutive
        # batches each get their own pre-pulled copy (no silent
        # overwrite). Staging is only honored while a prefetcher is
        # actively scoped (_stage_active > 0) — an abandoned loop's
        # leftovers must never serve a later unrelated pull with
        # pre-push values. Staleness contract: a staged row may predate
        # pushes issued after its pull — the reference's async/
        # half-async semantics (see ps/prefetch.py docstring).
        self._staged: Dict[bytes, "deque"] = {}
        self._stage_lock = make_lock("SparseTable._stage_lock")
        self._stage_active = 0

    def _shard(self, key: int) -> int:
        return int(key) % self.shard_num

    def _shard_ids(self, ids: np.ndarray) -> tuple:
        """Normalize ids to int64 and route them to shards — THE id->shard
        mapping; pull/push/load_state must all agree on it."""
        flat = np.asarray(ids).reshape(-1).astype(np.int64)
        return flat, flat % self.shard_num

    def pull(self, ids: np.ndarray) -> np.ndarray:
        """Gather rows (init-on-miss). Rows prefetched for this exact ids
        array by ps/prefetch.PullPrefetcher are consumed without touching
        the shards (the DownpourWorker overlap path); a miss falls
        through to a normal gather."""
        if self._staged and self._stage_active > 0:
            from .prefetch import _stage_key
            key = _stage_key(ids)
            rows = None
            with self._stage_lock:
                q = self._staged.get(key)
                if q:
                    rows = q.popleft()
                    if not q:
                        del self._staged[key]
            if rows is not None:
                return rows.reshape(
                    tuple(np.asarray(ids).shape) + (self.value_dim,))
        return self._pull_now(ids)

    def _pull_now(self, ids: np.ndarray) -> np.ndarray:
        """Gather rows, init-on-miss. Shard-batched: ids are grouped by
        shard with numpy, each shard lock is taken ONCE, and the rows
        stack in a tight comprehension — ~5x faster than the original
        per-key loop at CTR batch sizes (13k lookups/step on Criteo-26)."""
        flat, shards = self._shard_ids(ids)
        out = np.empty((flat.size, self.value_dim), np.float32)
        for s in np.unique(shards):
            mask = shards == s
            keys = flat[mask]
            shard = self._shards[s]
            with self._locks[s]:
                # dedupe misses (order-preserving): a repeated unseen id
                # must draw ONE init row, as the old per-key loop did
                missing = dict.fromkeys(
                    int(k) for k in keys if int(k) not in shard)
                for k in missing:
                    shard[k] = self._init(self._rng, self.value_dim)
                rows = [shard[int(k)] for k in keys]
            out[mask] = np.stack(rows)
        return out.reshape(tuple(np.asarray(ids).shape) + (self.value_dim,))

    def push(self, ids: np.ndarray, grads: np.ndarray):
        """Apply gradients to rows (sgd or adagrad per-row update)."""
        flat, _ = self._shard_ids(ids)   # same int64 keying as pull
        g = np.asarray(grads, np.float32).reshape(flat.size, self.value_dim)
        # combine duplicate ids first (scatter-add semantics)
        uniq, inv = np.unique(flat, return_inverse=True)
        combined = np.zeros((uniq.size, self.value_dim), np.float32)
        np.add.at(combined, inv, g)
        shards = uniq % self.shard_num
        for s in np.unique(shards):
            mask = shards == s
            shard = self._shards[s]
            accum = self._accum[s]
            with self._locks[s]:
                for k, gi in zip(uniq[mask], combined[mask]):
                    row = shard.get(int(k))
                    if row is None:
                        continue
                    if self.optimizer == "adagrad":
                        acc = accum.setdefault(
                            int(k), np.zeros(self.value_dim, np.float32))
                        acc += gi ** 2
                        row -= self.lr * gi / (np.sqrt(acc) + 1e-6)
                    else:
                        row -= self.lr * gi

    def size(self) -> int:
        return sum(len(s) for s in self._shards)

    def state(self):
        """Serializable snapshot (checkpoint tier). Optimizer
        accumulators ride under ``a:<key>`` entries so a restored
        adagrad table keeps its decayed step sizes (losing them makes
        the first post-restore updates ~lr instead of lr/sqrt(acc))."""
        rows = {}
        for s in self._shards:
            rows.update({str(k): v for k, v in s.items()})
        for s in self._accum:
            rows.update({f"a:{k}": v for k, v in s.items()})
        return rows

    def load_state(self, rows: Dict[str, np.ndarray]):
        for k, v in rows.items():
            if k.startswith("a:"):
                key = int(k[2:])
                self._accum[self._shard(key)][key] = \
                    np.asarray(v, np.float32)
            else:
                key = int(k)
                self._shards[self._shard(key)][key] = \
                    np.asarray(v, np.float32)


class TableRegistry:
    """Process-global registry (FleetWrapper singleton analog,
    framework/fleet/fleet_wrapper.h)."""

    def __init__(self):
        self._tables: Dict[str, SparseTable] = {}
        self._remote_factory = None

    def set_remote_factory(self, factory):
        """Multi-node mode: route new tables through the PS RPC client
        (runtime.connect_workers_to_servers)."""
        self._remote_factory = factory

    def get_or_create(self, name: str, value_dim: int, **kw) -> SparseTable:
        if name not in self._tables:
            if self._remote_factory is not None:
                self._tables[name] = self._remote_factory(
                    name, value_dim, **kw)
            else:
                self._tables[name] = SparseTable(name, value_dim, **kw)
        return self._tables[name]

    def get(self, name: str) -> Optional[SparseTable]:
        return self._tables.get(name)

    def tables(self):
        return dict(self._tables)

    def clear(self):
        self._tables.clear()


REGISTRY = TableRegistry()
