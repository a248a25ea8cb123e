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
``dataset``), as ``paddle_tpu/__init__.py`` exports them, and the
eager surface of the tape (:mod:`.dygraph`: ``Tensor``, ``to_tensor``,
``grad``, ``no_grad``, ``seed``, and ``tensor``'s functions). The package
imports torch and numpy only; it never imports jax or ``paddle_tpu``,
which stays the reference the port is tested against.
"""

import importlib
import importlib.util

from . import dataset, enforce, flags
from .device import resolve_device
from .flags import get_flag, get_flags, set_flags
from .fluid_compat import CPUPlace, CUDAPlace, DataFeeder, batch, reader

__all__ = ["CPUPlace", "CUDAPlace", "DataFeeder", "batch", "dataset",
           "enforce", "flags", "get_flag", "get_flags", "reader",
           "resolve_device", "set_flags"]


#: the tape's names, as ``paddle_tpu/__init__.py`` exports them; with
#: ``tensor`` (the :mod:`.tensor_api` module) and its functions (whose
#: ``seed`` and ``to_tensor`` the reference's star import binds last)
#: they are imported at their first use, so importing the package stays
#: light
_TAPE_NAMES = ("Parameter", "Tensor", "grad", "no_grad", "to_variable")


def __getattr__(name):
    if name == "fluid":
        from .fluid_compat import build_fluid_module
        mod = build_fluid_module()
        globals()["fluid"] = mod
        return mod
    if name in _TAPE_NAMES:
        dygraph = importlib.import_module(f"{__name__}.dygraph")
        value = globals()[name] = getattr(dygraph, name)
        return value
    if not name.startswith("_") and importlib.util.find_spec(
            f"{__name__}.{name}") is None:
        # not a submodule (``from . import jit`` asks for those first)
        tensor_api = importlib.import_module(f"{__name__}.tensor_api")
        if name == "tensor":
            globals()[name] = tensor_api
            return tensor_api
        value = getattr(tensor_api, name, None)
        if callable(value) and getattr(value, "__module__", None) == \
                tensor_api.__name__:
            globals()[name] = value
            return value
    raise AttributeError(
        f"module 'paddle_tpu_torch' has no attribute {name!r}")
