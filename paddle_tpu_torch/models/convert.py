"""Carrying GPT weights across from the JAX package.

The port keeps the JAX model's module tree and its ``[in, out]`` Linear
layout, so a structured name from ``paddle_tpu``'s
``named_parameters()`` (e.g. ``gpt.blocks.0.attn.qkv_proj.weight``) is
the port's ``state_dict`` key as it stands and no tensor is transposed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def gpt_state_from_numpy(arrays: Dict[str, np.ndarray],
                         device) -> Dict[str, torch.Tensor]:
    """JAX GPT parameters (name -> numpy array) -> a ``state_dict`` for
    :class:`~paddle_tpu_torch.models.gpt.GPTForCausalLM` on ``device``
    (load it with ``load_state_dict(..., strict=True)``, which rejects
    missing or unexpected names and mismatched shapes)."""
    return {name: torch.from_numpy(np.array(a, dtype=np.float32))
            .to(device) for name, a in arrays.items()}
