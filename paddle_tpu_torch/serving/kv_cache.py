"""KV caches for the serving engine — the counterpart of
``SlotKVCache``, ``BlockAllocator``, ``prefix_chain_keys``, ``BlockPool``
and ``BlockKVCache`` in ``paddle_tpu/serving/kv_cache.py``.

:class:`SlotKVCache` is the dense design (one ``max_len`` row per
request, the engine's ``paged=False``); :class:`BlockKVCache` the
block-paged one with its prefix cache. Host-side bookkeeping (free
lists, tables, lengths, refcounts, the prefix cache) is numpy and plain
Python, as in the JAX package, so allocation order and prefix sharing
replay identically. The KV tensors live on the engine's device, are
updated in place where JAX replaces its arrays, and are never rebound:
the serving graphs hold them by address.

The cross-cache handoff of disaggregated serving: several caches may
share one :class:`BlockPool` (``BlockKVCache(..., pool=)``);
``export_row`` detaches a row into a record that owns its block
references, ``import_row`` splices a record of the same pool into a
row (no reference or byte moves), and ``adopt_row`` copies a foreign
pool's committed blocks into fresh blocks of this pool, written in
place into the pool's own tensors (``index_copy_``), so every graph
captured over the pool reads the copied blocks.

Dispatch-ahead (the engine's ``dispatch_ahead``): where the reference
rebinds a pool's arrays (a step's ``set_arrays``, a COW copy, a
reclaimed block's scale reset, an adoption, a promotion), the port
writes in place and bumps :attr:`BlockPool.write_version` instead; a
speculative megastep is consumed only if the version it read is still
the pool's. A speculation over an int8 pool, or over any pool a host tier demotes
from, registers a :class:`TailSnapshot` of the blocks it may write (a
louder row re-encodes a block's committed rows; a frozen row writes at
its length); every such write first restores pending snapshots
(:meth:`BlockPool.note_write`), so a discarded speculation leaves the
committed codes and scales as the reference's, and a demotion reads the
committed blocks through them (:meth:`BlockPool.committed_block`).
"""

from __future__ import annotations

from bisect import insort
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..analysis import concurrency as _ccz

_KV_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}


def _pool_dtype(dtype, kv_dtype: str):
    """The reference's ``dtype`` override of a paged pool's storage type:
    the port's pools, its kernel's routes and its graphs are keyed by
    ``kv_dtype`` alone, so only ``kv_dtype``'s own type (or None) is
    taken (ROADMAP C)."""
    if dtype is None or kv_dtype not in _KV_DTYPES:
        return
    want = _KV_DTYPES[kv_dtype]
    name = getattr(dtype, "name", None) or str(dtype).replace("torch.", "")
    if name != str(want).replace("torch.", ""):
        raise NotImplementedError(
            f"dtype={dtype!r} is not taken: a paged pool's storage type "
            f"follows kv_dtype={kv_dtype!r} (ROADMAP C)")


class SlotKVCache:
    """Fixed-geometry KV storage and a slot free list: per layer a (k, v)
    pair of ``[max_slots, heads, max_len, head_dim]`` tensors on
    ``device``, one slot row per request. The decode and verify steps
    write the rows in place; the host-side ``lengths`` vector is each
    slot's valid prefix and the steps' position input."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 max_slots: int, max_len: int, dtype=None, *, device="cpu"):
        dtype = dtype or torch.float32
        shape = (max_slots, num_heads, max_len, head_dim)
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        self.layers: List[Tuple[torch.Tensor, torch.Tensor]] = [
            tuple(torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(2)) for _ in range(num_layers)]
        self.lengths = np.zeros(max_slots, np.int32)
        # kept sorted so admission order -> slot order is deterministic
        self._free = list(range(max_slots))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.max_slots - len(self._free)

    def alloc(self) -> Optional[int]:
        """Claim the lowest free slot, or None when full."""
        return self._free.pop(0) if self._free else None

    def release(self, slot: int):
        self.lengths[slot] = 0
        insort(self._free, slot)

    def write_prefill(self, slot: int, rows, length: int):
        """Install one prefilled row: ``rows`` is one (k, v) pair per
        layer shaped [1, heads, max_len, d]; ``length`` the true prompt
        length (the rows past it are padding the position mask hides
        until decode overwrites them)."""
        self.write_prefill_batch([slot], rows, [length])

    def write_prefill_batch(self, slots, rows, lengths):
        """Install several prefilled rows with one ``index_copy_`` per
        tensor: ``rows`` is one (k, v) pair per layer shaped [batch,
        heads, max_len, d] (a batched prefill's output, of which only the
        first ``len(slots)`` rows are meaningful), row i landing in
        ``slots[i]`` with true prompt length ``lengths[i]``."""
        n = len(slots)
        if n != len(lengths):
            raise ValueError(f"{n} slots but {len(lengths)} lengths")
        idx = torch.as_tensor(np.asarray(slots, np.int64),
                              device=self.layers[0][0].device)
        for layer, src in zip(self.layers, rows):
            for dst, r in zip(layer, src):
                dst.index_copy_(0, idx, r[:n])
        for s, ln in zip(slots, lengths):
            self.lengths[s] = int(ln)

    def advance(self, slot: int, n: int = 1):
        """Advance a slot's valid length by ``n`` freshly written rows (1
        for a decode token, K+1 after a speculative verify, then trimmed
        by :meth:`rollback`)."""
        ln = int(self.lengths[slot]) + int(n)
        if ln > self.max_len:
            raise ValueError(
                f"slot {slot}: advancing by {n} overflows capacity "
                f"max_len={self.max_len} (at {self.lengths[slot]})")
        self.lengths[slot] = ln

    def rollback(self, slot: int, n: int):
        """Roll a slot's write offset back over ``n`` rejected rows; they
        stay in the tensors past the valid length, behind the position
        mask, until the next write overwrites them."""
        if n < 0 or n > int(self.lengths[slot]):
            raise ValueError(
                f"slot {slot}: cannot roll back {n} rows from length "
                f"{self.lengths[slot]}")
        self.lengths[slot] = int(self.lengths[slot]) - int(n)

    def arrays(self):
        """The per-layer (k, v) tensors, as fed to the steps."""
        return list(self.layers)

    def drop_arrays(self):
        """Free the device tensors (a killed replica's): the host
        book-keeping stays, :meth:`arrays` is empty after."""
        self.layers = []

    def set_arrays(self, layers):
        """Take back a step's returned tensors, which must be the ones
        :meth:`arrays` handed out (the steps write them in place, and a
        captured graph holds them by address); raises ValueError for any
        other tensor, as :meth:`BlockKVCache.set_arrays` does."""
        _same_layers(layers, self.layers)


def _same_layers(layers, held):
    layers = [tuple(layer) for layer in layers]
    if len(layers) != len(held) or any(
            len(a) != len(b) or any(x is not y for x, y in zip(a, b))
            for a, b in zip(layers, held)):
        raise ValueError("set_arrays takes back the tensors arrays() "
                         "handed out; the steps update them in place")


class BlockAllocator:
    """Ref-counted free-list allocator over a fixed pool of KV blocks.

    The free list is kept sorted so allocation order is a pure function
    of the alloc/free history. A block's refcount goes above 1 only via
    the prefix cache; :meth:`deref` returns it to the free list at 0.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = int(num_blocks)
        self.refcount = np.zeros(num_blocks, np.int32)
        self._free = list(range(num_blocks))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self) -> Optional[int]:
        """Claim the lowest free block at refcount 1, or None if empty."""
        if not self._free:
            return None
        blk = self._free.pop(0)
        self.refcount[blk] = 1
        return blk

    def ref(self, blk: int):
        """Take an additional reference on an allocated block."""
        if self.refcount[blk] < 1:
            raise ValueError(f"block {blk} is free; cannot ref")
        self.refcount[blk] += 1

    def deref(self, blk: int):
        """Drop one reference; the block is reclaimed at zero."""
        if self.refcount[blk] < 1:
            raise ValueError(f"block {blk} is free; cannot deref")
        self.refcount[blk] -= 1
        if self.refcount[blk] == 0:
            insort(self._free, blk)

    def leaked(self) -> int:
        """Blocks still referenced — for the chaos suite's leak check
        (after every request releases, only permanent refs remain)."""
        return int((self.refcount > 0).sum())


class _PrefixEntry:
    """One cached full block of a prompt prefix: ``key`` is the rolling
    hash up to and including this block, ``parent_block`` the block
    this entry pins (None for a chain head), ``tokens`` guards against
    hash collisions."""

    __slots__ = ("key", "parent_block", "block", "tokens")

    def __init__(self, key, parent_block: Optional[int], block: int,
                 tokens: Tuple[int, ...]):
        self.key = key
        self.parent_block = parent_block
        self.block = block
        self.tokens = tokens


def prefix_chain_keys(prompt: Sequence[int], block_size: int) -> List[int]:
    """Rolling-hash chain keys ``hash((parent_key, chunk))`` for each
    full block of ``prompt``, the keys :class:`BlockKVCache` publishes
    prefix entries under."""
    bs = int(block_size)
    keys: List[int] = []
    key = None
    for i in range(len(prompt) // bs):
        chunk = tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
        key = hash((key, chunk))
        keys.append(key)
    return keys


class BlockPool:
    """The physical half of :class:`BlockKVCache`: the per-layer block
    tensors on ``device``, the ref-counted allocator and the rolling-hash
    prefix cache with its counters."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 block_size: int = 16, num_blocks: int = 2, dtype=None,
                 kv_dtype: str = "f32", *, device="cpu"):
        if kv_dtype not in _KV_DTYPES:
            raise ValueError(
                f"kv_dtype must be 'f32', 'bf16' or 'int8', got {kv_dtype!r}")
        _pool_dtype(dtype, kv_dtype)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks < 2:
            raise ValueError(
                f"num_blocks={num_blocks} leaves no usable block after "
                f"reserving the trash block")
        self.kv_dtype = kv_dtype
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.device = torch.device(device)
        shape = (self.num_blocks, num_heads, self.block_size, head_dim)
        dt = _KV_DTYPES[kv_dtype]

        def z(shp, dtype):
            return torch.zeros(shp, dtype=dtype, device=self.device)

        if kv_dtype == "int8":
            # 4-wide layers: int8 code pools + per-block-per-head absmax
            # scales; the model forward dispatches on the tuple width
            sshape = (self.num_blocks, num_heads)
            self.layers: List[Tuple[torch.Tensor, ...]] = [
                (z(shape, dt), z(shape, dt), z(sshape, torch.float32),
                 z(sshape, torch.float32)) for _ in range(num_layers)]
        else:
            self.layers = [(z(shape, dt), z(shape, dt))
                           for _ in range(num_layers)]
        self.allocator = BlockAllocator(self.num_blocks)
        trash = self.allocator.alloc()
        assert trash == BlockKVCache.TRASH
        # key -> _PrefixEntry, move_to_end on touch => LRU eviction order
        self._prefix: "OrderedDict[int, _PrefixEntry]" = OrderedDict()
        self.prefix_hits = 0       # token-weighted: shared tokens reused
        self.prefix_misses = 0     # prompt tokens prefilled from scratch
        self.blocks_allocated_total = 0   # fresh blocks taken by acquire
        # the reference's pool identity: bumped where it rebinds the
        # arrays; the speculations' snapshots still to restore or drop
        self.write_version = 0
        self._pending: List["TailSnapshot"] = []   # guarded-by: _spec_lock
        self._spec_lock = _ccz.make_lock("BlockPool._spec_lock")
        _ccz.declare_guarded(self, {"_pending": "_spec_lock"})

    def note_write(self):
        """About to write (or hand out) block contents the way the
        reference rebinds its arrays: restore every pending speculation's
        snapshot first, then bump :attr:`write_version`, so no
        speculation taken later sees these pools as the ones it read."""
        with self._spec_lock:
            pending, self._pending = self._pending, []
            for snap in pending:
                snap.restore()
        self.write_version += 1

    def retire(self, snap: Optional["TailSnapshot"], restore: bool) -> bool:
        """Retire one speculation's snapshot: restore it (a miss or a
        drop) or forget it (a hit). Returns False when a write restored it
        already, in which case the speculation must not be consumed."""
        if snap is None:
            return True
        with self._spec_lock:
            if snap not in self._pending:
                return False
            self._pending = [s for s in self._pending if s is not snap]
            if restore:
                snap.restore()
            return True

    def committed_block(self, blk: int):
        """Block ``blk`` of every layer (a tuple of its tensors per
        layer) as the commits left it: where a pending speculation's
        snapshot saved the block, the earliest one's copy (it saved what
        the commits left, before any speculation wrote), else the pool's
        own rows. A demotion reads through this, the reference's
        committed arrays."""
        with self._spec_lock:
            for snap in self._pending:
                j = snap.position(blk)
                if j is not None:
                    return [tuple(a[j] for a in layer)
                            for layer in snap.saved]
        return [tuple(a[blk] for a in layer) for layer in self.layers]

    def alloc_block(self) -> Optional[int]:
        """Fresh block, evicting idle prefix-cache entries if needed."""
        blk = self.allocator.alloc()
        while blk is None and self._evict_one_prefix():
            blk = self.allocator.alloc()
        return blk

    def _drop_entry(self, ent: _PrefixEntry):
        del self._prefix[ent.key]
        self.allocator.deref(ent.block)
        if ent.parent_block is not None:
            self.allocator.deref(ent.parent_block)

    def _evict_one_prefix(self) -> bool:
        """Drop the least-recently-used cache-only prefix entry (block at
        refcount 1). Children pin their parent, so chains evict
        leaf-first."""
        for key in list(self._prefix):
            ent = self._prefix[key]
            if self.allocator.refcount[ent.block] == 1:
                self._drop_entry(ent)
                return True
        return False

    def release_blocks(self, blocks: Sequence[int]):
        """Drop one reference per block: how an aborted handoff record
        (exported but never adopted) returns its ownership."""
        for blk in blocks:
            self.allocator.deref(int(blk))

    def flush_prefix_cache(self):
        """Drop every cached prefix ref (tests / memory pressure).
        Live requests keep their own refs; only cache refs drop."""
        for key in list(self._prefix):
            self._drop_entry(self._prefix[key])

    def drop_arrays(self):
        """Free the block tensors (a killed replica's pool): the
        allocator and the prefix cache's book-keeping stay."""
        self.layers = []


class TailSnapshot:
    """The blocks a speculative megastep of ``n`` iterations may write,
    saved before it is enqueued: for each row, the blocks its table names
    for positions ``pos .. pos + n - 1`` (a frozen or empty row writes
    at ``pos`` alone, into its own block or the trash block). Codes and
    scales are gathered on the device, in stream order after the
    megastep the speculation follows, and :meth:`restore` copies them
    back."""

    def __init__(self, pool: "BlockPool", tables: torch.Tensor,
                 pos: torch.Tensor, n: int):
        bs = pool.block_size
        span = (int(n) - 1) // bs + 2
        cols = (pos.long() // bs)[:, None] + torch.arange(
            span, device=pos.device)[None]
        cols = cols.clamp_(max=tables.shape[1] - 1)
        self.pool = pool
        self.idx = tables.long().gather(1, cols).reshape(-1)
        self._idx_host = None
        self.saved = [tuple(a.index_select(0, self.idx) for a in layer)
                      for layer in pool.layers]
        with pool._spec_lock:
            pool._pending = pool._pending + [self]

    def position(self, blk: int) -> Optional[int]:
        """The index of block ``blk`` in the saved copy, None when the
        speculation does not write it (read back once, on first use)."""
        if self._idx_host is None:
            self._idx_host = self.idx.tolist()
        try:
            return self._idx_host.index(int(blk))
        except ValueError:
            return None

    def restore(self):
        for layer, saved in zip(self.pool.layers, self.saved):
            for a, s in zip(layer, saved):
                a.index_copy_(0, self.idx, s)


class BlockKVCache:
    """Block-paged KV storage + ref-counted allocator + prefix cache.

    A request's logical positions ``[0, max_len)`` map through its row
    of the host-side ``tables`` array (``[max_slots, blocks_per_row]``
    int32) to physical blocks of the per-layer pools. Physical block 0
    is the trash block: permanently allocated, it backs every
    unassigned table entry and absorbs out-of-table writes.

    Prefix cache: full prompt blocks are published under a rolling hash
    of the token prefix. ``acquire`` refs the longest cached chain
    instead of re-prefilling it and copies the boundary block
    (copy-on-write) when the shared length is not block-aligned.

    ``pool`` shares an existing :class:`BlockPool` (co-located
    disaggregated roles): the geometry asked for must be the pool's.
    """

    TRASH = 0

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 max_slots: int, max_len: int, block_size: int = 16,
                 num_blocks: int = 0, prefix_cache: bool = True,
                 dtype=None, kv_dtype: str = "f32",
                 pool: Optional[BlockPool] = None, *, device="cpu"):
        _pool_dtype(dtype, kv_dtype)
        self.max_slots = int(max_slots)
        self.max_len = int(max_len)
        if pool is not None:
            # a sharing cache must see the pool it was asked for: a step
            # over another geometry would read the wrong blocks
            if pool.num_layers != int(num_layers) or \
                    pool.num_heads != int(num_heads) or \
                    pool.head_dim != int(head_dim):
                raise ValueError(
                    f"shared pool is {pool.num_layers} layers x "
                    f"{pool.num_heads} heads x {pool.head_dim} dims; "
                    f"cache wants {num_layers}x{num_heads}x{head_dim}")
            if num_blocks > 0 and int(num_blocks) != pool.num_blocks:
                raise ValueError(
                    f"shared pool has {pool.num_blocks} blocks; cannot "
                    f"resize to {num_blocks} through a sharing cache")
            if int(block_size) != pool.block_size:
                raise ValueError(
                    f"shared pool block_size={pool.block_size} != "
                    f"requested {block_size}")
            if kv_dtype != pool.kv_dtype:
                raise ValueError(
                    f"shared pool kv_dtype={pool.kv_dtype!r} != "
                    f"requested {kv_dtype!r}")
            self.pool = pool
        else:
            block_size = int(block_size)
            if block_size < 1:
                raise ValueError(
                    f"block_size must be >= 1, got {block_size}")
            if num_blocks <= 0:
                # worst case every row is full-length, +1 trash block
                num_blocks = (self.max_slots *
                              (-(-self.max_len // block_size)) + 1)
            self.pool = BlockPool(num_layers, num_heads, head_dim,
                                  block_size=block_size,
                                  num_blocks=num_blocks,
                                  kv_dtype=kv_dtype, device=device)
        self.blocks_per_row = -(-self.max_len // self.pool.block_size)
        self.tables = np.full((self.max_slots, self.blocks_per_row),
                              self.TRASH, np.int32)
        self.lengths = np.zeros(self.max_slots, np.int32)
        self._nblocks = np.zeros(self.max_slots, np.int32)  # owned per row
        self._free_rows = list(range(self.max_slots))
        self.prefix_cache_enabled = bool(prefix_cache)

    # -- pool delegation ---------------------------------------------

    @property
    def kv_dtype(self) -> str:
        return self.pool.kv_dtype

    @property
    def block_size(self) -> int:
        return self.pool.block_size

    @property
    def num_blocks(self) -> int:
        return self.pool.num_blocks

    @property
    def layers(self):
        return self.pool.layers

    @property
    def allocator(self) -> BlockAllocator:
        return self.pool.allocator

    @property
    def _prefix(self) -> "OrderedDict[int, _PrefixEntry]":
        return self.pool._prefix

    @property
    def prefix_hits(self) -> int:
        return self.pool.prefix_hits

    @property
    def prefix_misses(self) -> int:
        return self.pool.prefix_misses

    @property
    def blocks_allocated_total(self) -> int:
        """Fresh blocks every successful :meth:`acquire` took (shared
        prefix blocks excluded): ``bench.py``'s KV bytes per request."""
        return self.pool.blocks_allocated_total

    # -- geometry ----------------------------------------------------

    def blocks_needed(self, length: int) -> int:
        return -(-int(length) // self.block_size)

    @property
    def blocks_free(self) -> int:
        return self.allocator.num_free

    @property
    def blocks_used(self) -> int:
        return self.allocator.num_used

    @property
    def num_free(self) -> int:
        return len(self._free_rows)

    # -- allocation --------------------------------------------------

    def _match_prefix(self, prompt: Sequence[int]) -> List[_PrefixEntry]:
        """Longest chain of cached full blocks covering the prompt."""
        if not self.prefix_cache_enabled:
            return []
        bs = self.block_size
        matched: List[_PrefixEntry] = []
        key = None
        for i in range(len(prompt) // bs):
            chunk = tuple(prompt[i * bs:(i + 1) * bs])
            key = hash((key, chunk))
            ent = self._prefix.get(key)
            if ent is None or ent.tokens != chunk:
                break
            matched.append(ent)
        return matched

    def acquire(self, prompt: Sequence[int],
                need: int) -> Optional[Tuple[int, int]]:
        """Admit a request: reserve a row plus blocks for ``need``
        logical positions, reusing cached prefix blocks where possible.

        Returns ``(row, shared_tokens)`` — ``shared_tokens`` prompt
        positions already hold valid KV (always < len(prompt): the last
        prompt token is recomputed for its logits) — or None when rows
        or blocks run out. All-or-nothing: on block exhaustion every
        ref/alloc taken is unwound.
        """
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} positions > max_len={self.max_len}")
        if not self._free_rows:
            return None
        nblocks = self.blocks_needed(need)
        matched = self._match_prefix(prompt)
        shared = min(len(matched) * self.block_size, len(prompt) - 1)
        nshared = shared // self.block_size  # fully reusable blocks
        taken: List[int] = []
        reffed: List[int] = []
        blocks: List[int] = []
        for ent in matched[:nshared]:
            self.allocator.ref(ent.block)
            self._prefix.move_to_end(ent.key)
            reffed.append(ent.block)
            blocks.append(ent.block)
        cow = shared % self.block_size != 0
        for _ in range(nblocks - nshared):
            blk = self.pool.alloc_block()
            if blk is None:
                for b in taken:
                    self.allocator.deref(b)
                for b in reffed:
                    self.allocator.deref(b)
                return None
            taken.append(blk)
            blocks.append(blk)
        if (taken and self.kv_dtype == "int8") or cow:
            self.pool.note_write()
        if taken and self.kv_dtype == "int8":
            # a reclaimed block's stale absmax scale would distort every
            # fresh row quantized into it (scales only grow); zeroing it
            # restarts the block's grid and makes leftover codes
            # dequantize to 0. Before the COW copy, so a boundary block
            # still inherits its source's scale below.
            idx = torch.as_tensor(taken, dtype=torch.int64,
                                  device=self.pool.device)
            for layer in self.layers:
                layer[2][idx] = 0.0
                layer[3][idx] = 0.0
        if cow:
            # the boundary block is partially shared: copy the cached
            # block into the private one so the suffix prefill writes
            # the remainder in place (int8 scales copy the same way)
            src = matched[nshared].block
            dst = blocks[nshared]
            for layer in self.layers:
                for a in layer:
                    a[dst] = a[src]
        row = self._free_rows.pop(0)
        # counted here: a failed acquire unwinds its allocations
        self.pool.blocks_allocated_total += len(taken)
        self.tables[row] = self.TRASH
        self.tables[row, :nblocks] = blocks
        self._nblocks[row] = nblocks
        self.lengths[row] = 0
        if shared:
            self.pool.prefix_hits += shared
            self.pool.prefix_misses += len(prompt) - shared
        else:
            self.pool.prefix_misses += len(prompt)
        return row, shared

    def release_row(self, row: int):
        """Retire a request: deref every block its table row owns."""
        n = int(self._nblocks[row])
        for blk in self.tables[row, :n]:
            self.allocator.deref(int(blk))
        self.tables[row] = self.TRASH
        self._nblocks[row] = 0
        self.lengths[row] = 0
        insort(self._free_rows, row)

    def release(self, row: int):
        """:meth:`release_row`, under :class:`SlotKVCache`'s name."""
        self.release_row(row)

    def insert_prefix(self, row: int, prompt: Sequence[int]):
        """Publish a just-prefilled prompt's full blocks into the prefix
        cache. Blocks gain a cache ref; present entries are touched."""
        if not self.prefix_cache_enabled:
            return
        bs = self.block_size
        key = None
        for i in range(len(prompt) // bs):
            chunk = tuple(prompt[i * bs:(i + 1) * bs])
            parent = key
            key = hash((key, chunk))
            ent = self._prefix.get(key)
            if ent is not None:
                if ent.tokens != chunk:
                    break  # hash collision: leave the incumbent alone
                self._prefix.move_to_end(key)
                continue
            blk = int(self.tables[row, i])
            if blk == self.TRASH:
                break
            self.allocator.ref(blk)
            pin = None
            if parent is not None and parent in self._prefix:
                # children pin their parent so chains evict leaf-first
                pin = self._prefix[parent].block
                self.allocator.ref(pin)
            self._prefix[key] = _PrefixEntry(key, pin, blk, chunk)

    def flush_prefix_cache(self):
        """Drop every cached prefix ref (tests / memory pressure).
        Live requests keep their own refs; only cache refs drop."""
        self.pool.flush_prefix_cache()

    def drop_arrays(self):
        """Free the pool's block tensors (:meth:`BlockPool.drop_arrays`)."""
        self.pool.drop_arrays()

    @property
    def prefix_entries(self) -> int:
        return len(self._prefix)

    def match_prefix_blocks(self, prompt: Sequence[int]) -> int:
        """How many full leading blocks of ``prompt`` this pool's prefix
        cache holds: a read-only probe (no LRU touch, no refs) for
        prefix-affinity routing."""
        return len(self._match_prefix(prompt))

    # -- cross-cache handoff (disaggregated prefill/decode) ----------

    def export_row(self, row: int) -> Dict[str, object]:
        """Detach a row for handoff: the returned record owns the row's
        block references (ownership moves from the row to the record,
        no deref), and the row is freed for the next admission. The
        record must reach :meth:`import_row` / :meth:`adopt_row` of the
        destination cache, or drop its references through
        ``record["pool"].release_blocks(record["blocks"])``."""
        n = int(self._nblocks[row])
        rec = {
            "blocks": [int(b) for b in self.tables[row, :n]],
            "length": int(self.lengths[row]),
            "pool": self.pool,
        }
        self.tables[row] = self.TRASH
        self._nblocks[row] = 0
        self.lengths[row] = 0
        insort(self._free_rows, row)
        return rec

    def import_row(self, rec: Dict[str, object]) -> Optional[int]:
        """Adopt a record whose blocks live in this cache's pool: a
        host-side table splice, the record's references moving to the
        new row. Returns the row, or None when no row is free (the
        record keeps its references)."""
        if rec["pool"] is not self.pool:
            raise ValueError(
                "import_row requires a record from the same BlockPool; "
                "use adopt_row for cross-pool handoff")
        blocks = rec["blocks"]
        if len(blocks) > self.blocks_per_row:
            raise ValueError(
                f"record spans {len(blocks)} blocks > blocks_per_row="
                f"{self.blocks_per_row}")
        if not self._free_rows:
            return None
        row = self._free_rows.pop(0)
        self.tables[row] = self.TRASH
        self.tables[row, :len(blocks)] = blocks
        self._nblocks[row] = len(blocks)
        self.lengths[row] = int(rec["length"])
        return row

    def adopt_row(self, rec: Dict[str, object]) -> Optional[int]:
        """Adopt a record from another pool: take fresh blocks here
        (all or nothing) and copy the committed blocks' contents into
        them, in place, on the current stream (the one the step graphs
        replay on). Returns the row, or None when rows or blocks run out
        (the record keeps its source references). On success the caller
        still owns the source references and drops them through
        ``rec["pool"].release_blocks(...)``."""
        src_pool: BlockPool = rec["pool"]  # type: ignore[assignment]
        if src_pool is self.pool:
            raise ValueError(
                "adopt_row is for cross-pool handoff; use import_row "
                "when the record already lives in this pool")
        if src_pool.num_layers != self.pool.num_layers or \
                src_pool.num_heads != self.pool.num_heads or \
                src_pool.head_dim != self.pool.head_dim or \
                src_pool.block_size != self.pool.block_size or \
                src_pool.kv_dtype != self.pool.kv_dtype:
            raise ValueError("cannot adopt blocks across pools with "
                             "different geometry or kv_dtype")
        blocks = [int(b) for b in rec["blocks"]]  # type: ignore[union-attr]
        length = int(rec["length"])  # type: ignore[arg-type]
        if len(blocks) > self.blocks_per_row:
            raise ValueError(
                f"record spans {len(blocks)} blocks > blocks_per_row="
                f"{self.blocks_per_row}")
        if not self._free_rows:
            return None
        taken: List[int] = []
        for _ in blocks:
            blk = self.pool.alloc_block()
            if blk is None:
                for b in taken:
                    self.allocator.deref(b)
                return None
            taken.append(blk)
        dev = self.pool.device
        src_pool.note_write()
        self.pool.note_write()
        if taken and self.kv_dtype == "int8":
            # acquire()'s stale-scale hazard: zero the reclaimed blocks'
            # scales first; the copy below then writes the committed
            # blocks' real scales over them
            idx = torch.as_tensor(taken, dtype=torch.int64, device=dev)
            for layer in self.layers:
                layer[2].index_fill_(0, idx, 0.0)
                layer[3].index_fill_(0, idx, 0.0)
        # only blocks holding committed KV carry data worth moving;
        # trailing reservation blocks are uninitialized by contract
        ncommit = min(len(blocks), self.blocks_needed(length))
        if ncommit:
            src_idx = torch.as_tensor(blocks[:ncommit], dtype=torch.int64,
                                      device=dev)
            dst_idx = torch.as_tensor(taken[:ncommit], dtype=torch.int64,
                                      device=dev)
            for layer, src_layer in zip(self.layers, src_pool.layers):
                for a, sa in zip(layer, src_layer):
                    a.index_copy_(0, dst_idx, sa.index_select(0, src_idx))
        row = self._free_rows.pop(0)
        self.pool.blocks_allocated_total += len(taken)
        self.tables[row] = self.TRASH
        self.tables[row, :len(taken)] = taken
        self._nblocks[row] = len(taken)
        self.lengths[row] = length
        return row

    # -- per-step bookkeeping ----------------------------------------

    def commit_prefill(self, row: int, length: int):
        """The prompt pass populated this row's blocks up to ``length``."""
        if length > int(self._nblocks[row]) * self.block_size:
            raise ValueError(
                f"row {row}: prefill length {length} exceeds reserved "
                f"blocks ({self._nblocks[row]} x {self.block_size})")
        self.lengths[row] = int(length)

    def advance(self, row: int, n: int = 1):
        ln = int(self.lengths[row]) + int(n)
        if ln > int(self._nblocks[row]) * self.block_size:
            raise ValueError(
                f"row {row}: advancing by {n} overflows reserved blocks "
                f"({self._nblocks[row]} x {self.block_size} rows, at "
                f"{self.lengths[row]})")
        self.lengths[row] = ln

    def rollback(self, row: int, n: int):
        """Rewind over ``n`` rejected speculative rows. Blocks stay
        reserved (the worst case is reserved at admission), so a rollback
        across a block boundary is pure length arithmetic: the stale rows
        sit past the valid length, behind the position mask."""
        if n < 0 or n > int(self.lengths[row]):
            raise ValueError(
                f"row {row}: cannot roll back {n} rows from length "
                f"{self.lengths[row]}")
        self.lengths[row] = int(self.lengths[row]) - int(n)

    def arrays(self):
        """The per-layer block pools as fed to the steps: (k, v), or
        (k, v, k_scale, v_scale) for int8 pools."""
        return list(self.layers)

    def set_arrays(self, layers):
        """Take back a step's returned pools (2- or 4-wide layers), which
        must be the tensors :meth:`arrays` handed out: the steps write
        the pools in place, and a captured graph reads and writes them
        at their addresses, so a step that handed back other tensors
        would leave the cache holding memory the graphs never touch.
        Raises ValueError for any other tensor. Bumps the pool's
        :attr:`~BlockPool.write_version`, where the reference rebinds."""
        _same_layers(layers, self.layers)
        self.pool.write_version += 1
