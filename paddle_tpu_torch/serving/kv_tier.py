"""Host-RAM KV block tier, the counterpart of
``paddle_tpu/serving/kv_tier.py``: sessions beyond the device pool.

- :class:`HostBlockStore`: a host block pool holding prefix chains
  int8-at-rest (codes + per-block-per-head absmax scales on exactly the
  ``ops.quant_ops`` grid, so an int8 device pool's blocks round-trip
  losslessly and a f32/bf16 pool pays one quantization on demote).
  Refcounted like ``BlockAllocator``, with leaf-first LRU eviction under
  pressure. The arrays are block-major (``codes [blocks, layers, 2,
  heads, block_size, head_dim]``, ``scales [blocks, layers, 2, heads]``,
  k then v), in page-locked memory when CUDA is present (torch tensors
  with numpy views), so one block moves in one copy each way; the
  reference's per-layer ``k_codes`` / ``v_codes`` / ``k_scale`` /
  ``v_scale`` lists are views into them.

- :class:`TierManager`: migrates blocks device <-> host between steps.
  Demotion sweeps cold prefix chains (refcount 1: no live request, no
  resident child) leaf-first in LRU order: each block is gathered from
  every layer on the device and copied once into pinned staging, on the
  current stream, so it reads what the step before it wrote. Promotion
  is on demand: when ``acquire()``'s device chain runs out but the
  rolling hash continues into host-resident entries, the missing blocks
  are copied back all-or-nothing, with ``index_copy_`` into the pool's
  own tensors (graphs hold the pool by address; the reference rebinds
  its arrays), and republished as ordinary prefix entries. Both
  directions pass the ``serving.migrate`` fault site under
  ``RetryPolicy.from_flags``; a failed attempt unwinds every block it
  took.

- :class:`SessionStore`: conversation contexts keyed by session id, so
  ``ServingEngine.submit(session=...)`` resumes a demoted conversation:
  the engine prepends the stored context, the promoted chain covers the
  shared prefix, and only the unshared suffix re-prefills.

The store is fleet-shared: the routers attach one ``TierManager`` across
replicas and roles, so a chain demoted by one worker is promotable by
any other and outlives a killed worker's pool. Chain keys are the
pool-independent rolling hashes of ``prefix_chain_keys``: host entries
carry ``parent_key``, not a physical block. Like the reference's, the
keys hold tokens only, not the tenant: a chain demoted under one LoRA
tenant can be promoted for another (a fault of the reference that the
port reproduces).
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import flags as _flags
from .. import observability as _obs
from ..analysis import concurrency as _ccz
from ..observability import runlog as _runlog
from ..ops.quant_ops import KV_QMAX
from ..resilience.injector import fault_point
from ..resilience.retry import RetryError, RetryPolicy
from .kv_cache import BlockKVCache, _PrefixEntry


def _np_quantize(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """numpy mirror of ``ops.quant_ops.quantize_int8`` (same clamp, same
    1e-9 floor, same round-half-even): the host encode lands on the grid
    the device write path uses."""
    s = np.maximum(scale, 1e-9)
    return np.clip(np.round(x / s * KV_QMAX), -KV_QMAX, KV_QMAX).astype(np.int8)


def _np_dequantize(codes: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """numpy mirror of ``ops.quant_ops.dequantize_int8``."""
    return codes.astype(np.float32) * (scale / KV_QMAX)


class _MigrationSkip(Exception):
    """Internal: this one migration attempt is skipped by fault policy
    (an injected `skip` at serving.migrate). Nothing was taken."""


class _HostEntry:
    """One host-resident full block of a prefix chain: the host twin of
    ``_PrefixEntry``, its parent linked by rolling-hash ``parent_key``
    instead of a physical block (host entries outlive any one device
    pool). Constructing an entry hands it the block's reference."""

    __slots__ = ("key", "parent_key", "block", "tokens")

    def __init__(self, key, parent_key, block: int,
                 tokens: Tuple[int, ...]):
        self.key = key
        self.parent_key = parent_key
        self.block = int(block)
        self.tokens = tokens


class _HostAllocator:
    """Refcounted host block accounting: ``BlockAllocator`` semantics
    (alloc at refcount 1, ref/deref, exact ``leaked()``) without the trash
    block, so an empty store leaks exactly 0."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError("host tier needs at least 1 block")
        self.num_blocks = int(num_blocks)
        self.refcount = np.zeros(self.num_blocks, np.int32)
        self._free: List[int] = list(range(self.num_blocks))

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_used(self) -> int:
        return self.num_blocks - len(self._free)

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        blk = self._free.pop(0)
        self.refcount[blk] = 1
        return blk

    def ref(self, blk: int):
        if self.refcount[blk] < 1:
            raise RuntimeError(f"ref on free host block {blk}")
        self.refcount[blk] += 1

    def deref(self, blk: int):
        if self.refcount[blk] < 1:
            raise RuntimeError(f"deref on free host block {blk}")
        self.refcount[blk] -= 1
        if self.refcount[blk] == 0:
            self._free.append(blk)

    def leaked(self) -> int:
        return int((self.refcount > 0).sum())


class HostBlockStore:
    """Host pool of int8-at-rest KV blocks and the chain index.

    ``codes`` / ``scales`` (numpy) are block-major: ``[num_blocks,
    layers, 2, heads, block_size, head_dim]`` int8 and ``[num_blocks,
    layers, 2, heads]`` f32, k before v; ``k_codes[li]`` etc. are the
    reference's per-layer arrays as views. ``pin_memory`` (default:
    whether CUDA is present) puts them in page-locked memory, torch
    tensors ``codes_t`` / ``scales_t`` sharing the numpy arrays'
    storage, so block copies to and from the device run asynchronously
    on the copying stream. Preallocated, never resized.

    The chain index ``_chains`` is an OrderedDict keyed by rolling hash;
    ``touch`` is move_to_end, so iteration order is the LRU eviction
    order, leaf-first like the device prefix cache: a parent carries one
    pin per resident child (``_children`` counts them, so children may
    arrive before their parent in a leaf-first demotion sweep).

    Unsynchronized, like ``BlockPool``: the owning :class:`TierManager`
    serializes every touch under its lock."""

    def __init__(self, num_layers: int, num_heads: int, head_dim: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 *, pin_memory: Optional[bool] = None):
        if num_blocks is None:
            num_blocks = int(_flags.get_flag("serving_host_blocks"))
        if pin_memory is None:
            pin_memory = torch.cuda.is_available()
        self.num_layers = int(num_layers)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.block_size = int(block_size)
        self.num_blocks = int(num_blocks)
        self.pinned = bool(pin_memory)
        shape = (self.num_blocks, self.num_layers, 2, self.num_heads,
                 self.block_size, self.head_dim)
        sshape = (self.num_blocks, self.num_layers, 2, self.num_heads)
        self.codes_t = torch.zeros(shape, dtype=torch.int8,
                                   pin_memory=self.pinned)
        self.scales_t = torch.zeros(sshape, dtype=torch.float32,
                                    pin_memory=self.pinned)
        self.codes = self.codes_t.numpy()
        self.scales = self.scales_t.numpy()
        self.k_codes = [self.codes[:, li, 0] for li in range(self.num_layers)]
        self.v_codes = [self.codes[:, li, 1] for li in range(self.num_layers)]
        self.k_scale = [self.scales[:, li, 0]
                        for li in range(self.num_layers)]
        self.v_scale = [self.scales[:, li, 1]
                        for li in range(self.num_layers)]
        self.allocator = _HostAllocator(self.num_blocks)
        self._chains: "OrderedDict[int, _HostEntry]" = OrderedDict()
        self._children: Dict[int, int] = {}   # parent_key -> resident kids
        self.peak_used = 0        # high-water blocks referenced
        self.evictions = 0        # LRU drops under pressure
        # the last copy that reads host rows (a promotion's H2D copies):
        # a host write into a row waits for it first
        self._reading: Optional[torch.cuda.Event] = None

    @property
    def nbytes(self) -> int:
        """Host bytes the store holds (codes and scales)."""
        return self.codes.nbytes + self.scales.nbytes

    # ---------------------------------------------------------- blocks
    def acquire(self) -> Optional[int]:
        """Claim one host block at refcount 1, evicting idle chains LRU
        (leaf-first) while the free list is dry; None when every
        resident block is still needed."""
        blk = self.allocator.alloc()
        while blk is None and self._evict_one():
            blk = self.allocator.alloc()
        if blk is not None:
            self.peak_used = max(self.peak_used, self.allocator.num_used)
        return blk

    def release(self, blk: int):
        """Return the caller's reference on ``blk`` (the failed-demote
        unwind; entry-owned refs go through :meth:`drop`)."""
        self.allocator.deref(blk)

    def leaked(self) -> int:
        return self.allocator.leaked()

    # ----------------------------------------------------------- chains
    def get(self, key) -> Optional[_HostEntry]:
        return self._chains.get(key)

    def has_key(self, key) -> bool:
        return key in self._chains

    def touch(self, key):
        """LRU bump: host chains a promotion just re-materialized stay
        resident (fleet dedup: the next worker promotes them too)."""
        if key in self._chains:
            self._chains.move_to_end(key)

    def put(self, ent: _HostEntry):
        """Publish ``ent``, adopting its block reference. Pins the
        resident parent (if any) and retro-pins ``ent`` once per
        already-resident child."""
        if ent.key in self._chains:
            raise RuntimeError(f"host chain key {ent.key} already resident")
        self._chains[ent.key] = ent
        if ent.parent_key is not None:
            self._children[ent.parent_key] = (
                self._children.get(ent.parent_key, 0) + 1)
            parent = self._chains.get(ent.parent_key)
            if parent is not None:
                self.allocator.ref(parent.block)
        for _ in range(self._children.get(ent.key, 0)):
            self.allocator.ref(ent.block)

    def drop(self, ent: _HostEntry):
        """Unpublish ``ent``: release its own reference, unpin its
        resident parent, decrement the parent's child count."""
        del self._chains[ent.key]
        self.allocator.deref(ent.block)
        if ent.parent_key is not None:
            n = self._children.get(ent.parent_key, 0) - 1
            if n > 0:
                self._children[ent.parent_key] = n
            else:
                self._children.pop(ent.parent_key, None)
            parent = self._chains.get(ent.parent_key)
            if parent is not None:
                self.allocator.deref(parent.block)

    def _evict_one(self, count: bool = True) -> bool:
        """Drop the least-recently-used chain entry nobody pins
        (refcount 1: no resident child). ``count=False`` for teardown
        drops (``flush``), so ``evictions`` reports pressure only."""
        for key in list(self._chains):
            ent = self._chains[key]
            if self.allocator.refcount[ent.block] == 1:
                self.drop(ent)
                if count:
                    self.evictions += 1
                return True
        return False

    def flush(self):
        """Drop every chain entry (tests / teardown), leaf-first passes
        until empty."""
        while self._chains:
            if not self._evict_one(count=False):
                break

    # ----------------------------------------------------------- payload
    def _await_readers(self):
        """Wait for the copies still reading host rows before a row is
        overwritten."""
        if self._reading is not None:
            self._reading.synchronize()
            self._reading = None

    def read(self, blk: int) -> List[Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]]:
        """Views (no copy) of row ``blk``'s per-layer payload."""
        return [(self.k_codes[li][blk], self.v_codes[li][blk],
                 self.k_scale[li][blk], self.v_scale[li][blk])
                for li in range(self.num_layers)]

    def stats(self) -> Dict[str, int]:
        return {
            "host_blocks": self.num_blocks,
            "host_blocks_used": self.allocator.num_used,
            "host_blocks_free": self.allocator.num_free,
            "host_blocks_peak": self.peak_used,
            "host_chain_entries": len(self._chains),
            "host_evictions": self.evictions,
        }


class SessionStore:
    """Conversation contexts by session id: the engine prepends the
    stored context to the next turn's prompt, so the rolling hash walks
    the chain the previous turn published. Unsynchronized like
    :class:`HostBlockStore`; the owning :class:`TierManager` serializes
    access."""

    def __init__(self):
        self._ctx: Dict[str, List[int]] = {}
        self.resumed = 0          # submits that found a stored context

    def __len__(self) -> int:
        return len(self._ctx)

    def get(self, sid: str) -> Optional[List[int]]:
        ctx = self._ctx.get(sid)
        return None if ctx is None else list(ctx)

    def save(self, sid: str, context: Sequence[int]):
        self._ctx[sid] = [int(t) for t in context]

    def drop(self, sid: str):
        self._ctx.pop(sid, None)

    def session_ids(self) -> List[str]:
        return list(self._ctx)


class TierManager:
    """Device <-> host migration policy over one fleet-shared
    :class:`HostBlockStore` and :class:`SessionStore`.

    One TierManager serves any number of engines and pools; every public
    method takes the cache it operates on and serializes on ``_lock``.
    Both directions run the ``serving.migrate`` fault site per attempt
    under ``RetryPolicy.from_flags``: a skipped or exhausted demotion
    leaves the chain on the device, a skipped or exhausted promotion
    falls back to re-prefill, and any block taken mid-attempt is
    unwound. ``migrate_ms`` sums the host-clock time of the block copies
    each way (with their device waits), for the chip report."""

    def __init__(self, store: HostBlockStore,
                 demote_idle_ms: Optional[float] = None):
        if demote_idle_ms is None:
            demote_idle_ms = float(
                _flags.get_flag("serving_demote_idle_ms"))
        self.store = store
        self.sessions = SessionStore()
        self.demote_idle_ms = float(demote_idle_ms)
        self._lock = _ccz.make_lock("kv_tier._lock")
        self._migrated = {"demote": 0, "promote": 0}  # guarded-by: _lock
        self._dedup_blocks = 0                        # guarded-by: _lock
        self._resident: Dict[str, int] = {}           # guarded-by: _lock
        self._resumed = 0                             # guarded-by: _lock
        self.sessions_peak = 0                        # guarded-by: _lock
        self.migrate_ms = {"demote": 0.0, "promote": 0.0}  # guarded-by: _lock
        # demotion staging: one block of every layer's k and v as f32,
        # in pinned memory, made at the first float-pool demotion
        self._stage: Optional[torch.Tensor] = None    # guarded-by: _lock
        help_mig = "KV blocks migrated across the host tier, by direction"
        self._mig_demote_c = _obs.counter(
            "serving_kv_migrations", help_mig).labels(dir="demote")
        self._mig_promote_c = _obs.counter(
            "serving_kv_migrations", help_mig).labels(dir="promote")
        self._host_used_g = _obs.gauge(
            "serving_kv_blocks_used",
            "physical KV blocks currently referenced (paged serving)"
            ).labels(tier="host")
        self._host_free_g = _obs.gauge(
            "serving_kv_blocks_free",
            "physical KV blocks on the free list (paged serving)"
            ).labels(tier="host")
        self._sess_resident_g = _obs.gauge(
            "serving_sessions_resident",
            "sessions with a request currently queued or decoding")
        self._sess_host_g = _obs.gauge(
            "serving_sessions_host",
            "idle sessions whose context is stored in the host tier, "
            "resumable via submit(session=...)")
        self._sess_resumed_g = _obs.gauge(
            "serving_sessions_resumed",
            "submits that resumed a stored session context "
            "(re-prefilling only the unshared suffix)")
        self._update_gauges()
        # the reference's set, then the port's own (the copies' host
        # time and the pinned staging buffer, written by migrations)
        _ccz.declare_guarded(self, {
            "_migrated": "_lock", "_dedup_blocks": "_lock",
            "_resident": "_lock", "_resumed": "_lock",
            "sessions_peak": "_lock",
            "migrate_ms": "_lock", "_stage": "_lock",
        })

    # ------------------------------------------------------------ wiring
    def attach(self, cache: BlockKVCache) -> "TierManager":
        """Check ``cache``'s pool geometry against the store and hand
        back self. Any number of same-geometry caches may attach."""
        pool = cache.pool
        want = (self.store.num_layers, self.store.num_heads,
                self.store.head_dim, self.store.block_size)
        have = (pool.num_layers, pool.num_heads, pool.head_dim,
                pool.block_size)
        if want != have:
            raise ValueError(
                f"kv_tier geometry mismatch: host store has "
                f"(layers, heads, head_dim, block_size)={want}, "
                f"device pool has {have}")
        return self

    # ---------------------------------------------------------- demotion
    def demote(self, cache: BlockKVCache, keys=None,
               budget: Optional[int] = None) -> Tuple[int, int]:
        """Demote cold device prefix entries (refcount 1) into the host
        store, leaf-first in LRU order. ``keys`` restricts to an eligible
        set (the engine's idle-window filter); ``budget`` caps entries per
        sweep. Returns ``(entries_demoted, blocks_copied)``: the
        difference is fleet dedup (an entry whose chain block is already
        host-resident frees its device block with no copy)."""
        pool = cache.pool
        with self._lock:
            policy = RetryPolicy.from_flags("serving.migrate")
            by_block = {e.block: e for e in pool._prefix.values()}
            entries = blocks = 0
            progress = True
            while progress:     # children free their parents mid-sweep
                progress = False
                for key in list(pool._prefix):
                    if budget is not None and entries >= budget:
                        progress = False
                        break
                    ent = pool._prefix.get(key)
                    if ent is None:
                        continue
                    if keys is not None and key not in keys:
                        continue
                    if pool.allocator.refcount[ent.block] != 1:
                        continue
                    parent_key = None
                    if ent.parent_block is not None:
                        parent = by_block.get(ent.parent_block)
                        if parent is None:
                            continue    # orphaned pin; leave on device
                        parent_key = parent.key
                    try:
                        moved = policy.call(self._demote_attempt, pool,
                                            ent, parent_key)
                    except (_MigrationSkip, RetryError):
                        continue        # fault policy: stays on device
                    if moved is None:
                        progress = False
                        break           # host tier genuinely full
                    if moved < 0:
                        continue        # hash collision: keep on device
                    by_block.pop(ent.block, None)
                    pool._drop_entry(ent)
                    entries += 1
                    blocks += moved
                    progress = True
                    if moved == 0:
                        self._dedup_blocks += 1
                else:
                    continue
                break
            if entries:
                self._migrated["demote"] += blocks
                self._mig_demote_c.add(blocks)
                self._update_gauges()
                if _runlog.enabled():
                    _runlog.log_event(
                        "serving_kv_demote", entries=entries,
                        blocks=blocks, dedup=entries - blocks
                        if blocks < entries else 0,
                        host_used=self.store.allocator.num_used)
            return entries, blocks

    def _demote_attempt(self, pool, ent, parent_key):  # holds: _lock
        """One retried demotion: blocks copied (0 = the host already
        held the chain: dedup), None when the host store is full, -1 on
        a key collision (other tokens under the same hash: the device
        copy stays)."""
        kind = fault_point("serving.migrate")
        if kind == "skip":
            raise _MigrationSkip("serving.migrate skip")
        held = self.store.get(ent.key)
        if held is not None:
            if held.tokens != ent.tokens:
                return -1
            self.store.touch(ent.key)
            return 0
        hb = self.store.acquire()
        if hb is None:
            return None
        self._stage_out(pool, ent.block, hb)
        self.store.put(_HostEntry(ent.key, parent_key, hb, ent.tokens))
        return 1

    def _stage_out(self, pool, blk: int, hb: int):  # holds: _lock
        """Pull device block ``blk`` of every layer into host row ``hb``,
        encoded at rest: one gather on the device and one copy to the
        host per tensor kind. An int8 pool hands over its codes and
        scales verbatim (lossless); a f32/bf16 pool's block comes over as
        f32 into pinned staging and is quantized there with fresh
        per-head absmax scales (``_np_quantize``: the reference's codes
        and scales bit for bit). The copies run on the current stream,
        after the step that wrote the block; where a speculative megastep
        enqueued since may write it, its snapshot's copy is read
        (:meth:`BlockPool.committed_block`)."""
        t0 = time.perf_counter()
        store = self.store
        store._await_readers()
        # the committed block: a pending speculation's write into it is
        # left out, as the reference demotes the arrays its step left
        layers = pool.committed_block(blk)
        if pool.kv_dtype == "int8":
            codes = torch.stack([torch.stack((layer[0], layer[1]))
                                 for layer in layers])
            scales = torch.stack([torch.stack((layer[2], layer[3]))
                                  for layer in layers])
            store.codes_t[hb].copy_(codes, non_blocking=store.pinned)
            store.scales_t[hb].copy_(scales, non_blocking=store.pinned)
            _sync(pool.device)
        else:
            if self._stage is None:
                self._stage = torch.empty(
                    store.codes_t.shape[1:], dtype=torch.float32,
                    pin_memory=store.pinned)
            kv = torch.stack([torch.stack((layer[0], layer[1]))
                              for layer in layers])
            self._stage.copy_(kv, non_blocking=store.pinned)
            _sync(pool.device)
            x = self._stage.numpy()                  # [L, 2, h, bs, d]
            s = np.max(np.abs(x), axis=(3, 4))       # [L, 2, h]
            store.codes[hb] = _np_quantize(x, s[..., None, None])
            store.scales[hb] = s
        self.migrate_ms["demote"] += (time.perf_counter() - t0) * 1e3

    # --------------------------------------------------------- promotion
    def promote(self, cache: BlockKVCache, prompt: Sequence[int]) -> int:
        """Copy the host-resident continuation of ``prompt``'s prefix
        chain back into ``cache``'s pool and republish it as device
        prefix entries, so the next ``acquire()`` shares it like any warm
        prefix. All-or-nothing: if the pool cannot hold the whole
        continuation the attempt unwinds and returns 0 (the caller
        re-prefills). Host copies stay resident for the rest of the
        fleet. Returns blocks promoted."""
        if not cache.prefix_cache_enabled:
            return 0
        pool = cache.pool
        with self._lock:
            plan = self._promote_plan(pool, prompt)
            if plan is None:
                return 0
            try:
                n = RetryPolicy.from_flags("serving.migrate").call(
                    self._promote_attempt, pool, plan)
            except (_MigrationSkip, RetryError):
                return 0
            if n:
                self._migrated["promote"] += n
                self._mig_promote_c.add(n)
                self._update_gauges()
                if _runlog.enabled():
                    _runlog.log_event(
                        "serving_kv_promote", blocks=n,
                        tokens=n * pool.block_size,
                        device_free=pool.allocator.num_free)
            return n

    def _promote_plan(self, pool, prompt):  # holds: _lock
        """Walk ``prompt``'s rolling-hash chain: past the device-resident
        prefix, collect the consecutive host-resident (token-verified)
        continuation. None when the device chain already covers
        everything the host knows."""
        bs = pool.block_size
        key = None
        tail = None          # deepest device-resident entry (pin point)
        cands = []
        for i in range(len(prompt) // bs):
            chunk = tuple(int(t) for t in prompt[i * bs:(i + 1) * bs])
            key = hash((key, chunk))
            dent = pool._prefix.get(key)
            if dent is not None and dent.tokens == chunk:
                if cands:
                    break    # device re-entry past a host gap: unusable
                tail = dent
                continue
            hent = self.store.get(key)
            if hent is None or hent.tokens != chunk:
                break
            cands.append((key, chunk, hent))
        if not cands:
            return None
        return (tail, cands)

    def _promote_attempt(self, pool, plan):  # holds: _lock
        """One retried promotion. The fault point fires before any block
        is taken; the alloc loop unwinds on shortfall."""
        kind = fault_point("serving.migrate")
        if kind == "skip":
            raise _MigrationSkip("serving.migrate skip")
        tail, cands = plan
        # the extra ref keeps the matched leaf (hence, through the child
        # pins, the whole chain) off alloc_block's eviction
        if tail is not None:
            pool.allocator.ref(tail.block)
        try:
            taken: List[int] = []
            for _ in cands:
                blk = pool.alloc_block()
                if blk is None:
                    pool.release_blocks(taken)
                    return 0    # all-or-nothing under pool pressure
                taken.append(blk)
            self._copy_in(pool, taken, [c[2].block for c in cands])
            parent = tail
            for (key, chunk, _hent), blk in zip(cands, taken):
                pin = None
                if parent is not None:
                    pin = parent.block
                    pool.allocator.ref(pin)
                pool._prefix[key] = _PrefixEntry(key, pin, blk, chunk)
                self.store.touch(key)   # stays host-resident: fleet dedup
                parent = pool._prefix[key]
            return len(taken)
        finally:
            if tail is not None:
                pool.allocator.deref(tail.block)

    def _copy_in(self, pool, dst_blocks, src_blocks):  # holds: _lock
        """Host -> device copy of whole blocks (one copy per block and
        tensor kind, asynchronous from pinned rows), then ``index_copy_``
        into each layer's own pool tensors: codes and scales verbatim for
        an int8 pool, dequantized (``codes * (scale / 127)``, then cast
        to the pool's dtype, to nearest even) for a f32/bf16 one. The
        factor ``scale / 127`` is divided on the host in numpy, as the
        reference divides it: the card's division by a scalar multiplies
        by the reciprocal, one ulp off now and then. The store records an
        event after the copies; a later host write into a row waits for
        it."""
        t0 = time.perf_counter()
        # the reference rebinds the pool here: a dispatch-ahead
        # speculation over it is restored first and will miss
        pool.note_write()
        store, dev = self.store, pool.device
        n = len(src_blocks)
        int8 = pool.kv_dtype == "int8"
        codes = torch.empty((n, *store.codes_t.shape[1:]), dtype=torch.int8,
                            device=dev)
        scales = torch.empty((n, *store.scales_t.shape[1:]),
                             dtype=torch.float32, device=dev)
        for j, b in enumerate(src_blocks):
            codes[j].copy_(store.codes_t[b], non_blocking=store.pinned)
            if int8:
                scales[j].copy_(store.scales_t[b], non_blocking=store.pinned)
        if not int8:
            fac = store.scales[np.asarray(src_blocks)] / np.float32(KV_QMAX)
            scales.copy_(torch.from_numpy(fac))
        if dev.type == "cuda":
            store._reading = torch.cuda.Event()
            store._reading.record()
        dst = torch.as_tensor(list(dst_blocks), dtype=torch.int64,
                              device=dev)
        if int8:
            for li, (k, v, ks, vs) in enumerate(pool.layers):
                k.index_copy_(0, dst, codes[:, li, 0])
                v.index_copy_(0, dst, codes[:, li, 1])
                ks.index_copy_(0, dst, scales[:, li, 0])
                vs.index_copy_(0, dst, scales[:, li, 1])
        else:
            dt = pool.layers[0][0].dtype
            kv = (codes.to(torch.float32) * scales[..., None, None]).to(dt)
            for li, (k, v) in enumerate(pool.layers):
                k.index_copy_(0, dst, kv[:, li, 0])
                v.index_copy_(0, dst, kv[:, li, 1])
        self.migrate_ms["promote"] += (time.perf_counter() - t0) * 1e3

    # ---------------------------------------------------------- sessions
    def session_context(self, sid: str) -> Optional[List[int]]:
        with self._lock:
            return self.sessions.get(sid)

    def session_started(self, sid: str):
        """A request for ``sid`` was admitted to some engine's queue."""
        with self._lock:
            self._resident[sid] = self._resident.get(sid, 0) + 1
            self._bump_session_peak()
            self._update_gauges()

    def session_released(self, sid: str):
        """A request for ``sid`` left the engine (finished, shed or
        canceled): the resident gauge drops, the stored context (if the
        request finished) stays resumable."""
        with self._lock:
            n = self._resident.get(sid, 0) - 1
            if n > 0:
                self._resident[sid] = n
            else:
                self._resident.pop(sid, None)
            self._update_gauges()

    def session_resumed(self, sid: str, stored_tokens: int,
                        prompt_tokens: int):
        with self._lock:
            self.sessions.resumed += 1
            self._resumed += 1
            self._update_gauges()
            if _runlog.enabled():
                _runlog.log_event(
                    "serving_session_resume", session=sid,
                    stored_tokens=stored_tokens,
                    prompt_tokens=prompt_tokens)

    def session_save(self, sid: str, context: Sequence[int]):
        with self._lock:
            self.sessions.save(sid, context)
            self._bump_session_peak()
            self._update_gauges()

    def _bump_session_peak(self):  # holds: _lock
        live = set(self._resident)
        live.update(self.sessions.session_ids())
        if len(live) > self.sessions_peak:
            self.sessions_peak = len(live)

    # -------------------------------------------------------- accounting
    def has_chain(self, key) -> bool:
        """Whether the host store holds an entry for this chain key: the
        fleet prefix index asks, to keep affinity entries whose device
        copy died with a worker."""
        with self._lock:
            return self.store.has_key(key)

    def leaked(self) -> int:
        """Host blocks still referenced (``flush()`` first to drop chain
        residency, as ``flush_prefix_cache`` on the device)."""
        with self._lock:
            return self.store.leaked()

    def flush(self):
        with self._lock:
            self.store.flush()
            self._update_gauges()

    def _update_gauges(self):  # holds: _lock
        self._host_used_g.set(self.store.allocator.num_used)
        self._host_free_g.set(self.store.allocator.num_free)
        self._sess_resident_g.set(len(self._resident))
        self._sess_host_g.set(len(self.sessions))
        self._sess_resumed_g.set(self._resumed)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self.store.stats())
            out.update({
                "migrated_demote_blocks": self._migrated["demote"],
                "migrated_promote_blocks": self._migrated["promote"],
                "demote_dedup_entries": self._dedup_blocks,
                "sessions_resident": len(self._resident),
                "sessions_host": len(self.sessions),
                "sessions_resumed": self._resumed,
                "sessions_peak": self.sessions_peak,
            })
            return out


def _sync(device: torch.device):
    """Wait for the current stream's copies to the host (none to wait
    for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
