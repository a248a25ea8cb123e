"""Carrying model weights and optimizer state across from the JAX package.

The port keeps each JAX model's module tree, its ``[in, out]`` Linear
layout and its OIHW convolution filters, so a structured name from
``paddle_tpu``'s ``named_parameters()`` / ``state_dict()``
(``gpt.blocks.0.attn.qkv_proj.weight``, ``ernie.encoder.layers.0.
self_attn.q_proj.weight``, ``layer1.0.bn1._mean``, ...) is the port's
``state_dict`` key as it stands and no tensor is transposed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def state_from_numpy(arrays: Dict[str, np.ndarray],
                     device) -> Dict[str, torch.Tensor]:
    """A JAX model's parameters, or its whole ``state_dict()`` with
    BatchNorm's ``_mean`` / ``_variance`` buffers (structured name ->
    numpy array) -> a ``state_dict`` for the port's model of the same
    family on ``device``: the same names, no transpose
    (:class:`~paddle_tpu_torch.models.gpt.GPTForCausalLM`, the ERNIE
    models of :mod:`~paddle_tpu_torch.models.ernie`, the vision models of
    :mod:`~paddle_tpu_torch.vision.models`; load it with
    ``load_state_dict(..., strict=True)``, which rejects missing or
    unexpected names and mismatched shapes)."""
    return {name: torch.from_numpy(np.array(a, dtype=np.float32))
            .to(device) for name, a in arrays.items()}


#: the GPT slice's name for :func:`state_from_numpy`
gpt_state_from_numpy = state_from_numpy

#: the names for the layers of :mod:`paddle_tpu_torch.nn`: the
#: Transformer's (``encoder.layers.0.self_attn.q_proj.weight``, ...), the
#: recurrent layers' (``weight_ih_l0``, ``bias_hh_l1_rev``, a cell's
#: ``_rnn.weight_ih_l0``) and every other layer's (``weight``, ``bias``,
#: ``_mean``, ``_variance``) are the JAX package's, in the same layouts
#: (``[in, out]`` Linear weights, ``[G*h, in]`` recurrent weights,
#: ``[in, out / groups, kh, kw]`` transposed-convolution filters)
transformer_state_from_numpy = state_from_numpy
rnn_state_from_numpy = state_from_numpy
layer_state_from_numpy = state_from_numpy


def optimizer_state_from_numpy(state: Dict[str, object],
                               names: Dict[str, str],
                               device) -> Dict[str, object]:
    """The JAX optimizer's ``state_dict()`` (``"<param name>:<key>"`` ->
    array for every accumulator key, ``velocity``, ``moment``, ``m1``,
    ``m2``, ``b1p``, ``b2p``, ``ms``, ``mom``, ``sq``, ``lin``, plus
    ``"_lr"``; arrays as numpy, bf16 moments as numpy ``bfloat16``) -> a
    ``state_dict`` for the port's optimizer of the same class on
    ``device``.

    ``names`` maps each JAX parameter's own name (``p.name``, e.g.
    ``linear_0.w_0``) to its structured name (``gpt.blocks.0.attn.
    qkv_proj.weight``), which is how the port's optimizer keys its state.
    Moment dtypes are kept: bf16 values travel through float32, which
    holds them exactly."""
    out: Dict[str, object] = {}
    for key, value in state.items():
        if key == "_lr":
            out[key] = float(value)
            continue
        pname, _, slot = key.rpartition(":")
        a = np.asarray(value)
        t = torch.from_numpy(np.array(a, dtype=np.float32)).to(device)
        if str(a.dtype) == "bfloat16":
            t = t.to(torch.bfloat16)
        out[f"{names[pname]}:{slot}"] = t
    return out


#: the AdamW slice's name for :func:`optimizer_state_from_numpy`
adamw_state_from_numpy = optimizer_state_from_numpy
