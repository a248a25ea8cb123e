"""The transformer layers — the counterpart of
``paddle_tpu/nn/transformer.py``: ``MultiHeadAttention`` with its
``Cache`` (incremental self-attention: keys and values grow by the new
rows) and ``StaticCache`` (cross-attention: the memory's keys and values
projected once), ``TransformerEncoderLayer`` / ``TransformerEncoder``,
``TransformerDecoderLayer`` / ``TransformerDecoder`` (post-LN by default,
pre-LN with ``normalize_before``) and the encoder-decoder
``Transformer``.

Without attention dropout the attention is the ``fused_attention_qkv``
op, by the reference's predicate: the flash kernels when
``use_pallas_attention`` is on, ``s_q == s_k >= pallas_min_seq`` and no
mask is given (an encoder's self-attention, a cross-attention over a
memory of the target's length), the composed form otherwise (the
decoder's masked self-attention, an incremental step). With it, the
composed matmul/softmax/dropout chain the reference uses, so that
dropout sees the probabilities. Dropout draws torch's random bits, not
the reference's. ``need_weights`` is taken and ignored, as in the
reference.

The stacks clone their first layer from its constructor arguments with
fresh parameters, as the reference's ``_clone_layer`` does; parameters
are drawn on ``device`` (None: CUDA, which must be present) from
``generator`` (None: one seeded with 0 on ``device``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..amp.auto_cast import autocast_inputs
from ..device import resolve_device, resolve_generator
from ..ops.attention_ops import fused_attention_qkv
from . import functional as F
from .layers_common import Dropout, LayerNorm, Linear


def _placed(device, generator):
    device = resolve_device(device)
    return device, resolve_generator(device, generator)


class MultiHeadAttention(nn.Module):
    """q/k/v projections and attention over ``[batch, seq, embed]``
    inputs; ``key`` defaults to ``query`` and ``value`` to ``key``, whose
    widths are ``kdim`` / ``vdim`` (default ``embed_dim``). ``attn_mask``
    is additive, broadcastable to ``[b, heads, s_q, s_k]``. With a
    :class:`Cache` the new keys and values are appended to the cached
    ones and ``forward`` returns ``(out, new Cache)``; with a
    :class:`StaticCache` its keys and values are used as they are and
    ``forward`` returns ``out`` alone."""

    class Cache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    class StaticCache:
        def __init__(self, k, v):
            self.k, self.v = k, v

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, *, device=None, generator=None):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not a multiple of "
                             f"num_heads {num_heads}")
        device, generator = _placed(device, generator)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        init = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                    device=device, generator=generator)
        self.q_proj = Linear(embed_dim, embed_dim, **init)
        self.k_proj = Linear(kdim or embed_dim, embed_dim, **init)
        self.v_proj = Linear(vdim or embed_dim, embed_dim, **init)
        self.out_proj = Linear(embed_dim, embed_dim, **init)

    def _split_heads(self, x):
        b, s, _ = x.shape
        return x.reshape(b, s, self.num_heads, self.head_dim).transpose(1, 2)

    def gen_cache(self, key, value=None, type=None):  # noqa: A002
        """A :class:`StaticCache` of ``key`` / ``value``'s projected heads
        (``type=StaticCache``), else an empty :class:`Cache` (f32 keys
        and values of length 0)."""
        if type is MultiHeadAttention.StaticCache:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value if value is not None
                                              else key))
            return MultiHeadAttention.StaticCache(k, v)
        z = torch.zeros((key.shape[0], self.num_heads, 0, self.head_dim),
                        dtype=torch.float32, device=key.device)
        return MultiHeadAttention.Cache(z, z)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        key = query if key is None else key
        value = key if value is None else value
        q = self._split_heads(self.q_proj(query))
        if isinstance(cache, MultiHeadAttention.StaticCache):
            k, v = cache.k, cache.v
        else:
            k = self._split_heads(self.k_proj(key))
            v = self._split_heads(self.v_proj(value))
            if isinstance(cache, MultiHeadAttention.Cache):
                ck, k = autocast_inputs("concat", cache.k, k)
                cv, v = autocast_inputs("concat", cache.v, v)
                k, v = torch.cat([ck, k], dim=2), torch.cat([cv, v], dim=2)
                cache = MultiHeadAttention.Cache(k, v)
        if not (self.training and self.dropout > 0.0):
            out = fused_attention_qkv(q, k, v, mask=attn_mask, causal=False)
        else:
            logits = F.matmul(q, k.transpose(-1, -2))
            logits = logits * (1.0 / float(np.sqrt(self.head_dim)))
            if attn_mask is not None:
                logits = F.add(logits, attn_mask)
            probs = F.dropout(F.softmax(logits), self.dropout)
            out = F.matmul(probs, v)
        b, h, s, d = out.shape
        out = self.out_proj(out.transpose(1, 2).reshape(b, s, h * d))
        if cache is not None and not isinstance(
                cache, MultiHeadAttention.StaticCache):
            return out, cache
        return out


class TransformerEncoderLayer(nn.Module):
    """Self-attention then a feed-forward block, each with a residual
    and a LayerNorm after it (``normalize_before=False``) or before it;
    ``activation`` names a function of :mod:`.functional` (``"relu"``,
    ``"gelu"``). With ``cache`` (from :meth:`gen_cache`) the
    self-attention appends to it and ``forward`` returns ``(out,
    cache)``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, generator=None):
        super().__init__()
        device, generator = _placed(device, generator)
        self._config = dict(
            d_model=d_model, nhead=nhead, dim_feedforward=dim_feedforward,
            dropout=dropout, activation=activation, attn_dropout=attn_dropout,
            act_dropout=act_dropout, normalize_before=normalize_before,
            weight_attr=weight_attr, bias_attr=bias_attr, device=device,
            generator=generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        init = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                    device=device, generator=generator)
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

    def forward(self, src, src_mask=None, cache=None):
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        if cache is None:
            src = self.self_attn(src, src, src, src_mask)
        else:
            src, cache = self.self_attn(src, src, src, src_mask, cache)
        src = F.add(residual, self.dropout1(src))
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
        return src if cache is None else (src, cache)

    def gen_cache(self, src):
        return self.self_attn.gen_cache(src)


def _clone(layer):
    """A fresh layer of ``layer``'s configuration (new parameters from
    the same generator), the reference's ``_clone_layer``."""
    return type(layer)(**layer._config)


class TransformerEncoder(nn.Module):
    """``encoder_layer`` followed by ``num_layers - 1`` fresh layers of
    the same configuration, then the optional final ``norm``; with
    ``cache`` (a list from :meth:`gen_cache`) returns ``(out, new
    caches)``."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [_clone(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        output = src
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, src_mask)
            else:
                output, c = mod(output, src_mask, cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, src):
        return [layer.gen_cache(src) for layer in self.layers]


class TransformerDecoderLayer(nn.Module):
    """Masked self-attention, cross-attention over ``memory``, then a
    feed-forward block, each with a residual and a LayerNorm after it
    (or before it with ``normalize_before``). With ``cache = (self
    Cache, cross StaticCache)`` (from :meth:`gen_cache`) the
    self-attention appends to its cache, the cross-attention reads the
    static one, and ``forward`` returns ``(out, new cache)``."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None, *,
                 device=None, generator=None):
        super().__init__()
        device, generator = _placed(device, generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self._config = dict(
            d_model=d_model, nhead=nhead, dim_feedforward=dim_feedforward,
            dropout=dropout, activation=activation, attn_dropout=attn_dropout,
            act_dropout=act_dropout, normalize_before=normalize_before,
            weight_attr=weight_attr, bias_attr=bias_attr, device=device,
            generator=generator)
        init = dict(weight_attr=weight_attr, bias_attr=bias_attr,
                    device=device, generator=generator)
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            **init)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             **init)
        self.linear1 = Linear(d_model, dim_feedforward, **init)
        self.linear2 = Linear(dim_feedforward, d_model, **init)
        self.norm1 = LayerNorm(d_model, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.norm3 = LayerNorm(d_model, device=device)
        self.dropout1 = Dropout(dropout)
        self.dropout2 = Dropout(dropout)
        self.dropout3 = Dropout(dropout)
        self.act_dropout = Dropout(act_dropout)
        self.activation = getattr(F, activation)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        if cache is None:
            tgt = self.self_attn(tgt, tgt, tgt, tgt_mask)
        else:
            tgt, sc = self.self_attn(tgt, tgt, tgt, tgt_mask, cache[0])
        tgt = F.add(residual, self.dropout1(tgt))
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        if cache is None:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask)
        else:
            tgt = self.cross_attn(tgt, memory, memory, memory_mask, cache[1])
        tgt = F.add(residual, self.dropout2(tgt))
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self.act_dropout(self.activation(
            self.linear1(tgt))))
        tgt = F.add(residual, self.dropout3(tgt))
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt if cache is None else (tgt, (sc, cache[1]))

    def gen_cache(self, memory):
        return (self.self_attn.gen_cache(memory),
                self.cross_attn.gen_cache(memory, memory,
                                          MultiHeadAttention.StaticCache))


class TransformerDecoder(nn.Module):
    """``decoder_layer`` followed by ``num_layers - 1`` fresh layers of
    the same configuration, then the optional final ``norm``; with
    ``cache`` (a list from :meth:`gen_cache`) returns ``(out, new
    caches)``."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer] + [_clone(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        output = tgt
        new_caches = []
        for i, mod in enumerate(self.layers):
            if cache is None:
                output = mod(output, memory, tgt_mask, memory_mask)
            else:
                output, c = mod(output, memory, tgt_mask, memory_mask,
                                cache[i])
                new_caches.append(c)
        if self.norm is not None:
            output = self.norm(output)
        return output if cache is None else (output, new_caches)

    def gen_cache(self, memory):
        return [layer.gen_cache(memory) for layer in self.layers]


class Transformer(nn.Module):
    """The encoder-decoder (``d_model`` 512, 8 heads, 6 + 6 layers, FFN
    2048 by default: Transformer-base). ``forward(src, tgt, src_mask,
    tgt_mask, memory_mask)`` encodes ``src`` and decodes ``tgt`` over the
    memory; with ``normalize_before`` each stack ends in a LayerNorm."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 custom_encoder=None, custom_decoder=None, *, device=None,
                 generator=None):
        super().__init__()
        device, generator = _placed(device, generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before, weight_attr,
                bias_attr)
        place = dict(device=device, generator=generator)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_norm = (LayerNorm(d_model, device=device)
                        if normalize_before else None)
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, **place), num_encoder_layers,
                enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_norm = (LayerNorm(d_model, device=device)
                        if normalize_before else None)
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, **place), num_decoder_layers,
                dec_norm)
        self.d_model = d_model
        self.nhead = nhead

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask)
        return self.decoder(tgt, memory, tgt_mask, memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, *, device=None):
        """``[length, length]`` float32: 0 on and below the diagonal,
        ``finfo(float32).min`` above it (on ``device``, default the
        CPU)."""
        keep = torch.tril(torch.ones((length, length), dtype=torch.bool,
                                     device=device))
        return torch.where(keep, 0.0, float(np.finfo(np.float32).min)).to(
            torch.float32)
