"""Multi-tenant paged LoRA, the counterpart of ``paddle_tpu/serving/lora.py``:
the block-table trick applied to weights.

:class:`LoRAPool` is to adapter weights what the paged KV pool is to KV
state. One fixed pool of stacked low-rank factors per projection target
(``A [layers, pages, in_dim, r]`` / ``B [layers, pages, r, out_dim]``,
f32, on the engine's device) is held by the serving steps by address, as
the KV pools are; each batch row carries an int32 adapter-page id, a
small input copied in before each replay, and the model gathers its page
inside the step (``index_select`` on the page axis). Page 0 is the
permanently allocated base page and stays all-zero, so base rows compute
a zero delta: base and tenant traffic mix freely in one batch of one
graph.

Loading and evicting an adapter write the pool's own tensors in place
(``copy_`` into ``A[:, page]``, ``zero_()`` on evict), on the current
stream, under the pool's lock. The reference rebinds its arrays with
``.at[:, page].set``; a rebind here would leave every captured graph
reading the old storage, so the tensors are never rebound: a load or an
evict adds no step signature and captures nothing, and a hot reload
shows in the very next replay.

Page bookkeeping reuses the KV plane's ref-counted
:class:`~paddle_tpu_torch.serving.kv_cache.BlockAllocator`: a load
allocates a page, every in-flight request refs its tenant's page, and
``evict`` refuses while requests still hold it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..analysis import concurrency as _ccz
from ..device import resolve_device
from .kv_cache import BlockAllocator

__all__ = ["LoRAPool", "make_adapter"]

# Projection targets, in pool-tensor order: (attr label, in-dim, out-dim)
# with dims resolved from the model config at pool construction.
TARGETS = ("attn.qkv_proj", "attn.out_proj", "fc1", "fc2")

BASE_PAGE = 0  # permanently-allocated all-zero page backing base rows


def _target_dims(cfg) -> Dict[str, Tuple[int, int]]:
    h = int(cfg.hidden_size)
    f = int(cfg.ffn_hidden_size)
    return {"attn.qkv_proj": (h, 3 * h), "attn.out_proj": (h, h),
            "fc1": (h, f), "fc2": (f, h)}


class LoRAPool:
    """A paged pool of per-tenant LoRA factors for one model config.

    ``arrays`` is the 8-tuple the steps hold: ``(Aq, Bq, Ao, Bo, A1,
    B1, A2, B2)``, each stacked ``[num_layers, pages, ...]`` with ``pages
    = max_adapters + 1`` (page 0 = base). Engines bound to the same pool
    (a router's replicas, a disaggregated fleet's roles) resolve tenants
    by *name* per step, so page ids never travel between engines.
    ``device`` None means CUDA and raises without one."""

    def __init__(self, cfg, rank: int, max_adapters: int, *, device=None):
        if not isinstance(rank, int) or rank < 1:
            raise ValueError(f"lora rank must be an int >= 1, got {rank!r}")
        if not isinstance(max_adapters, int) or max_adapters < 1:
            raise ValueError(
                f"lora max_adapters must be an int >= 1, got "
                f"{max_adapters!r}")
        self.device = resolve_device(device)
        self.rank = rank
        self.max_adapters = max_adapters
        self.pages = max_adapters + 1
        self.num_layers = int(cfg.num_layers)
        self._dims = _target_dims(cfg)
        arrs = []
        for t in TARGETS:
            din, dout = self._dims[t]
            arrs.append(torch.zeros((self.num_layers, self.pages, din, rank),
                                    dtype=torch.float32, device=self.device))
            arrs.append(torch.zeros((self.num_layers, self.pages, rank, dout),
                                    dtype=torch.float32, device=self.device))
        self.arrays = tuple(arrs)
        # bumped by every load and evict, where the reference rebinds
        # its arrays: a dispatch-ahead speculation compares it
        self.load_version = 0               # guarded-by: _lock
        self._by_name: Dict[str, int] = {}  # guarded-by: _lock
        self._alloc = BlockAllocator(self.pages)
        base = self._alloc.alloc()
        assert base == BASE_PAGE
        # one pool serves many engines; with threaded dispatch they pin
        # and release pages from different worker threads. Reentrant:
        # evict -> in_use and acquire -> page_of nest. Engines take it
        # after their own _step_lock; the pool never calls back into an
        # engine, so the order is acyclic.
        self._lock = _ccz.make_lock("lora_pool._lock", reentrant=True)
        _ccz.declare_guarded(self, {"arrays": "_lock",
                                    "load_version": "_lock"})

    @property
    def shape_key(self) -> Tuple[int, int]:
        """The (rank, pages) geometry: the step-cache key component."""
        return (self.rank, self.pages)

    def adapter_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Expected ``{name: shape}`` of one adapter state dict."""
        shapes = {}
        for t in TARGETS:
            din, dout = self._dims[t]
            shapes[f"{t}.A"] = (self.num_layers, din, self.rank)
            shapes[f"{t}.B"] = (self.num_layers, self.rank, dout)
        return shapes

    @property
    def loaded(self):
        with self._lock:
            return sorted(self._by_name)

    def page_of(self, name: str) -> int:
        """The live page of a tenant name (``""`` = base page 0)."""
        if not name:
            return BASE_PAGE
        with self._lock:
            page = self._by_name.get(name)
        if page is None:
            raise ValueError(
                f"unknown lora adapter {name!r} (loaded: {self.loaded})")
        return page

    def acquire(self, name: str) -> int:
        """Pin a tenant's page for one in-flight request."""
        with self._lock:
            page = self.page_of(name)
            if page != BASE_PAGE:
                self._alloc.ref(page)
            return page

    def release(self, name: str):
        with self._lock:
            page = self._by_name.get(name) if name else None
            if page is not None and self._alloc.refcount[page] > 1:
                self._alloc.deref(page)

    def in_use(self, name: str) -> int:
        """In-flight requests currently pinning a tenant's page."""
        with self._lock:
            page = self._by_name.get(name)
            return (0 if page is None
                    else int(self._alloc.refcount[page]) - 1)

    def load(self, name: str, state) -> int:
        """Load (or hot-reload) an adapter into a pool page.

        ``state`` maps ``"{target}.A"`` / ``"{target}.B"`` to stacked
        ``[num_layers, ...]`` factors (numpy, torch, or anything
        ``numpy.asarray`` takes); names and shapes are validated before
        anything is written. Each factor is copied into its page of the
        pool's own tensor: no graph notices."""
        if not name:
            raise ValueError("adapter name must be non-empty")
        want = self.adapter_shapes()
        missing = sorted(set(want) - set(state))
        if missing:
            raise ValueError(f"adapter {name!r} missing factors: {missing}")
        unknown = sorted(set(state) - set(want))
        if unknown:
            raise ValueError(f"adapter {name!r} has unknown factors: "
                             f"{unknown}")
        for key, shape in want.items():
            got = tuple(np.shape(state[key]))
            if got != shape:
                raise ValueError(
                    f"adapter {name!r} factor {key}: shape {got} != "
                    f"expected {shape}")
        with self._lock:
            page = self._by_name.get(name)
            if page is None:
                page = self._alloc.alloc()
                if page is None:
                    raise ValueError(
                        f"lora pool full ({self.max_adapters} adapters); "
                        f"evict one first (loaded: {self.loaded})")
                self._by_name[name] = page
            with torch.no_grad():
                for i, t in enumerate(TARGETS):
                    for j, part in enumerate(("A", "B")):
                        v = state[f"{t}.{part}"]
                        if not isinstance(v, torch.Tensor):
                            v = torch.from_numpy(
                                np.asarray(v, dtype=np.float32))
                        self.arrays[2 * i + j][:, page].copy_(v)
            self.load_version += 1
        return page

    def evict(self, name: str) -> int:
        """Free a tenant's page and zero it; refuses while requests
        still pin it."""
        with self._lock:
            page = self._by_name.get(name)
            if page is None:
                raise ValueError(
                    f"unknown lora adapter {name!r} "
                    f"(loaded: {self.loaded})")
            busy = self.in_use(name)
            if busy:
                raise ValueError(
                    f"adapter {name!r} is pinned by {busy} in-flight "
                    f"request(s); drain before evicting")
            del self._by_name[name]
            self._alloc.deref(page)
            with torch.no_grad():
                for a in self.arrays:
                    a[:, page].zero_()
            self.load_version += 1
        return page

    def leaked(self) -> int:
        """Pages still pinned beyond their load ref (the chaos leak
        check); 0 when every request released (the base page never
        counts)."""
        with self._lock:
            return int((self._alloc.refcount[1:] > 1).sum())


def make_adapter(cfg, rank: int, seed: int = 0,
                 scale: float = 0.05) -> Dict[str, np.ndarray]:
    """A seeded random adapter state dict, the reference's draws: both
    factors non-zero (a zero-initialized B would make every output
    base-identical, useless for asserting per-tenant divergence)."""
    rng = np.random.RandomState(seed)
    dims = _target_dims(cfg)
    layers = int(cfg.num_layers)
    state = {}
    for t in TARGETS:
        din, dout = dims[t]
        state[f"{t}.A"] = (rng.randn(layers, din, rank) * scale
                          ).astype(np.float32)
        state[f"{t}.B"] = (rng.randn(layers, rank, dout) * scale
                          ).astype(np.float32)
    return state
