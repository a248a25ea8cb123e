"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100).

This slice carries the paged serving path: GPT models
(:mod:`.models.gpt`), the block-paged KV cache and the continuous
batching :class:`~.serving.ServingEngine`, with paged attention running
through a hand-written CUDA kernel (:mod:`.ops.cuda.paged_attention`).
The package imports torch and numpy only; it never imports jax or
``paddle_tpu``, which stays the reference the port is tested against.
"""

from . import flags
from .device import resolve_device
from .flags import get_flag, get_flags, set_flags

__all__ = ["flags", "get_flag", "get_flags", "resolve_device", "set_flags"]
