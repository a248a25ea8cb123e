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
Fluid-era programs run through ``paddle_tpu_torch.fluid`` (built at its
first use) and the classic readers (``batch``, ``reader``,
``dataset``), as ``paddle_tpu/__init__.py`` exports them. The package
imports torch and numpy only; it never imports jax or ``paddle_tpu``,
which stays the reference the port is tested against.
"""

from . import dataset, enforce, flags
from .device import resolve_device
from .flags import get_flag, get_flags, set_flags
from .fluid_compat import CPUPlace, CUDAPlace, DataFeeder, batch, reader

__all__ = ["CPUPlace", "CUDAPlace", "DataFeeder", "batch", "dataset",
           "enforce", "flags", "get_flag", "get_flags", "reader",
           "resolve_device", "set_flags"]


def __getattr__(name):
    if name == "fluid":
        from .fluid_compat import build_fluid_module
        mod = build_fluid_module()
        globals()["fluid"] = mod
        return mod
    raise AttributeError(
        f"module 'paddle_tpu_torch' has no attribute {name!r}")
