"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for NVIDIA
Hopper (H100).

It serves GPT models through a block-paged KV cache and a continuous
batching :class:`~.serving.ServingEngine` (paged attention in a
hand-written CUDA kernel), and trains GPT and ERNIE models as
``bench.py`` trains them: :func:`.jit.to_static` and
:func:`.jit.to_static_multi_step` capture the step (forward, backward,
:class:`~.optimizer.AdamW`) as one CUDA graph, with flash attention,
LayerNorm and the multi-tensor AdamW update in hand-written kernels
(:mod:`.ops.cuda`) and per-block recompute (``GPTConfig.recompute``).
The package imports torch and numpy only; it never imports jax or
``paddle_tpu``, which stays the reference the port is tested against.
"""

from . import flags
from .device import resolve_device
from .flags import get_flag, get_flags, set_flags

__all__ = ["flags", "get_flag", "get_flags", "resolve_device", "set_flags"]
