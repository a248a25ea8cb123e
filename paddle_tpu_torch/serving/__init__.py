"""Serving plane of the port: the continuous-batching engine over the
block-paged or the dense slotted KV cache, multi-tenant paged LoRA, the
host KV tier, the replica router in front of several engines, the
disaggregated prefill/decode fleet, the HTTP front end and the JSON
grammar of constrained decoding (counterpart of ``paddle_tpu/serving``)."""

from .decoding import DecodeParams, JsonGrammar, json_token_strings
from .disagg import DecodeEngine, DisaggRouter, HandoffQueue, PrefillEngine
from .engine import QueueFullError, Request, ServingEngine
from .http import ServingHTTPServer
from .kv_cache import BlockAllocator, BlockKVCache, BlockPool, SlotKVCache
from .kv_tier import HostBlockStore, SessionStore, TierManager
from .lora import LoRAPool, make_adapter
from .router import HEALTH_STATES, AutoscalePolicy, ReplicaRouter

__all__ = ["AutoscalePolicy", "BlockAllocator", "BlockKVCache", "BlockPool",
           "DecodeEngine", "DecodeParams", "DisaggRouter", "HEALTH_STATES",
           "HandoffQueue", "HostBlockStore", "JsonGrammar", "LoRAPool",
           "PrefillEngine",
           "QueueFullError", "ReplicaRouter", "Request", "ServingEngine",
           "ServingHTTPServer", "SessionStore", "SlotKVCache", "TierManager",
           "json_token_strings", "make_adapter"]
