"""The paged serving steps — counterparts of ``decode_step_paged`` and
``_unwrap_pools`` in ``paddle_tpu/models/generation.py`` and of the
engine's paged prefill body (``serving/engine.py:_prefill_entry_paged``).

PyTorch runs eagerly, so these are plain functions over the model and
the pools: there is no jit, no per-geometry step cache and no
parameter injection yet (capturing the steps as CUDA graphs is later
work). JAX's ``_wrap_pools`` has no counterpart: pools are plain
tensors here, with no Tensor wrapper to lift them into. The pools are
updated in place by the forward and returned for symmetry with the
JAX steps.
"""

from __future__ import annotations

import torch

from ..serving.decoding import sample_tokens


def _unwrap_pools(newp):
    """Split off the quantization-error scalar that int8 layers append
    (5th element): returns ``(pools, max_qerr)``, ``max_qerr`` being the
    max over layers (an exact 0.0 for float pools)."""
    qerr = None
    pools = []
    for layer in newp:
        if len(layer) == 5:
            qerr = layer[4] if qerr is None else torch.maximum(qerr, layer[4])
            layer = layer[:4]
        pools.append(tuple(layer))
    if qerr is None:
        qerr = torch.zeros((), dtype=torch.float32)
    return pools, qerr


@torch.no_grad()
def decode_step_paged(model, tokens, pos, tables, pools, attn_impl=None):
    """One greedy decode step over the paged pools.

    ``tokens [b] i32``, ``pos [b] i32`` (each row's committed length,
    where its token is written), ``tables [b, T] i32`` -> ``(next_tokens
    [b] i32, last_logits [b, V], pools, max_qerr)``.
    """
    logits, newp = model(tokens[:, None].long(), cache=pools, cache_pos=pos,
                         block_tables=tables, attn_impl=attn_impl)
    lg = logits[:, -1]
    pools, qerr = _unwrap_pools(newp)
    return sample_tokens(lg), lg, pools, qerr


@torch.no_grad()
def prefill_paged(model, ids, last, pos, tables, pools, attn_impl=None):
    """One batched prompt-suffix pass writing KV through per-row block
    tables: ``ids [b, bucket]``, ``last [b]`` (each row's true last
    token index), ``pos [b]`` (each row's write offset, its shared
    prefix length) -> ``(logits at last [b, V], pools, max_qerr)``."""
    logits, newp = model(ids.long(), cache=pools, cache_pos=pos,
                         block_tables=tables, attn_impl=attn_impl)
    lg = logits[torch.arange(logits.shape[0], device=logits.device),
                last.long()]
    pools, qerr = _unwrap_pools(newp)
    return lg, pools, qerr
