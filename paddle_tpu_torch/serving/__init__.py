"""Serving plane of the port: the continuous-batching engine over the
block-paged KV cache (counterpart of ``paddle_tpu/serving``)."""

from .decoding import DecodeParams
from .engine import QueueFullError, Request, ServingEngine

__all__ = ["DecodeParams", "QueueFullError", "Request", "ServingEngine"]
