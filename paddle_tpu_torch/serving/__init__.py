"""Serving plane of the port: the continuous-batching engine over the
block-paged or the dense slotted KV cache (counterpart of
``paddle_tpu/serving``)."""

from .decoding import DecodeParams
from .engine import QueueFullError, Request, ServingEngine
from .kv_cache import BlockAllocator, BlockKVCache, BlockPool, SlotKVCache

__all__ = ["BlockAllocator", "BlockKVCache", "BlockPool", "DecodeParams",
           "QueueFullError", "Request", "ServingEngine", "SlotKVCache"]
