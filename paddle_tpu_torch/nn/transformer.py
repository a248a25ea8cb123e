"""The encoder half of the transformer layers — the counterpart of
``paddle_tpu/nn/transformer.py:23-193``: ``MultiHeadAttention`` without
caches, ``TransformerEncoderLayer`` (post-LN by default, pre-LN with
``normalize_before``) and ``TransformerEncoder``.

Without attention dropout the attention is the ``fused_attention_qkv``
op with the additive mask (the composed form below ``pallas_min_seq``
or with a mask); with it, the composed matmul/softmax/dropout chain the
reference uses so that dropout sees the probabilities. Dropout draws
torch's random bits, not the reference's. The caches
(``Cache``/``StaticCache``, ``gen_cache``) and the decoder stack are not
ported yet.
"""

from __future__ import annotations

import math

from torch import nn

from ..ops.attention_ops import fused_attention_qkv
from . import functional as F
from .layers_common import Dropout, LayerNorm, Linear


class MultiHeadAttention(nn.Module):
    """Self-attention over a ``[batch, seq, embed]`` input: q/k/v
    projections of the same rows (the reference's separate key/value
    inputs and ``kdim``/``vdim`` wait for a ported model that uses them);
    ``attn_mask`` is additive, broadcastable to ``[b, heads, s, s]``."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, *, device,
                 generator):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        init = dict(device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **init)
        self.k_proj = Linear(embed_dim, embed_dim, **init)
        self.v_proj = Linear(embed_dim, embed_dim, **init)
        self.out_proj = Linear(embed_dim, embed_dim, **init)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def forward(self, x, attn_mask=None):
        q = self._split_heads(self.q_proj(x))
        k = self._split_heads(self.k_proj(x))
        v = self._split_heads(self.v_proj(x))
        if not (self.training and self.dropout > 0.0):
            out = fused_attention_qkv(q, k, v, mask=attn_mask, causal=False)
        else:
            logits = F.matmul(q, k.transpose(-1, -2))
            logits = logits * (1.0 / math.sqrt(self.head_dim))
            if attn_mask is not None:
                logits = F.add(logits, attn_mask)
            probs = F.dropout(F.softmax(logits), self.dropout)
            out = F.matmul(probs, v)
        b, h, s, d = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, s, h * d))


class TransformerEncoderLayer(nn.Module):
    """Self-attention then a feed-forward block, each with a residual
    and a LayerNorm after it (``normalize_before=False``) or before it;
    ``activation`` names a function of :mod:`.functional` (``"relu"``,
    ``"gelu"``)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, *, device, generator):
        super().__init__()
        self._config = dict(
            d_model=d_model, nhead=nhead, dim_feedforward=dim_feedforward,
            dropout=dropout, activation=activation, attn_dropout=attn_dropout,
            act_dropout=act_dropout, normalize_before=normalize_before,
            device=device, generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        init = dict(device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **init)
        self.linear1 = Linear(d_model, dim_feedforward, **init)
        self.linear2 = Linear(dim_feedforward, d_model, **init)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, src, src_mask=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = F.add(residual, self.dropout1(
            self.self_attn(src, src_mask)))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.act_dropout(self.activation(
            self.linear1(src))))
        src = F.add(residual, self.dropout2(src))
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """``encoder_layer`` followed by ``num_layers - 1`` fresh layers of
    the same configuration (new parameters, as the reference's
    ``_clone_layer``), then the optional final ``norm``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [type(encoder_layer)(**encoder_layer._config)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None):
        for layer in self.layers:
            src = layer(src, src_mask)
        return src if self.norm is None else self.norm(src)
