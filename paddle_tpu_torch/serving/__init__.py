"""Serving plane of the port: the continuous-batching engine over the
block-paged or the dense slotted KV cache, and the replica router in front
of several engines (counterpart of ``paddle_tpu/serving``)."""

from .decoding import DecodeParams
from .engine import QueueFullError, Request, ServingEngine
from .kv_cache import BlockAllocator, BlockKVCache, BlockPool, SlotKVCache
from .router import HEALTH_STATES, AutoscalePolicy, ReplicaRouter

__all__ = ["AutoscalePolicy", "BlockAllocator", "BlockKVCache", "BlockPool",
           "DecodeParams", "HEALTH_STATES", "QueueFullError",
           "ReplicaRouter", "Request", "ServingEngine", "SlotKVCache"]
