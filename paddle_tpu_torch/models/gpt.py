"""GPT-2-class decoder-only LM — the counterpart of
``paddle_tpu/models/gpt.py``.

Same structure and parameter names as the JAX model (``gpt.wte``,
``gpt.blocks.<i>.attn.qkv_proj``, ...), pre-LN blocks, a fused qkv
projection and an LM head tied to the token embedding. Every attention
path of the reference is ported: the no-cache causal forward, which
goes through ``fused_attention_qkv`` (the CUDA flash kernels at ``seq >=
pallas_min_seq``) and with ``labels`` returns the training loss; the
block-paged KV cache branch the paged serving engine drives; the
fixed-capacity (slotted) cache branch that offline generation and the
dense engine drive (``cache`` and ``cache_pos``: the new rows are
written in place at each row's offset, then composed attention under
the position mask, as the reference's ``fused_attention_qkv`` with a
mask always composes); and the concat branch (``cache`` alone: the
cache grows by the new rows, then causal attention). The ops cast
under AMP as the reference's do, so under ``auto_cast(level="O2")`` the
residual stream runs in bf16 and LayerNorm and the loss in f32.
The cache branches take multi-tenant LoRA (``lora=``: each batch row's
adapter page gathered from a stacked pool and its low-rank delta added to
the qkv, output, fc1 and fc2 projections, ``paddle_tpu/models/gpt.py
:98-109``). ``GPTConfig.recompute`` (the reference's ``fleet.utils.recompute`` over
every decoder block, ``paddle_tpu/models/gpt.py:379-381``) runs each
block of the no-cache forward through ``torch.utils.checkpoint``, which
keeps only the block's input and recomputes the rest in the backward
pass, under the AMP state of the forward. At dropout 0 nothing random is replayed; with dropout
the recomputation replays the forward's masks from the saved RNG state,
which a CUDA graph capture does not allow, so that combination raises
under capture.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.utils.checkpoint
from torch import nn

from .. import flags as _flags
from ..device import resolve_device, resolve_generator
from ..nn import functional as F
from ..nn.layers_common import Dropout, Embedding, LayerNorm, Linear
from ..amp.auto_cast import amp_state, amp_state_guard, \
    autocast_inputs
from ..device import capturing
from ..ops.attention_ops import (_composed_attention, block_gather,
                                 block_gather_dequant, block_scatter_write,
                                 block_scatter_write_quant,
                                 cache_scatter_write, decode_attention_mask,
                                 fused_attention_qkv)
from ..ops.cuda.paged_attention import paged_attention

ATTN_IMPLS = ("kernel", "composed")


@dataclass
class GPTConfig:
    vocab_size: int = 50304          # 50257 padded up to a 128 multiple
    max_position_embeddings: int = 1024
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_hidden_size: int = 4096
    dropout: float = 0.0
    init_std: float = 0.02
    # rematerialize each block's activations in backward (the reference's
    # batch-size lever: recompute over every decoder block)
    recompute: bool = False
    # pad the embedding rows up to a multiple of this; logits are
    # sliced back to vocab_size
    vocab_pad_to: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def padded_vocab_size(self) -> int:
        pad = max(1, int(self.vocab_pad_to))
        return -(-self.vocab_size // pad) * pad


GPT_CONFIGS = {
    "gpt2-tiny": GPTConfig(hidden_size=128, num_layers=2, num_heads=4,
                           ffn_hidden_size=512, vocab_size=1024,
                           max_position_embeddings=128),
    "gpt2-small": GPTConfig(hidden_size=768, num_layers=12, num_heads=12,
                            ffn_hidden_size=3072),
    "gpt2-medium": GPTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                             ffn_hidden_size=4096),   # the 345M baseline
    "gpt2-1p3b": GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                           ffn_hidden_size=8192),
    "gpt2-1p1b": GPTConfig(hidden_size=2048, num_layers=20, num_heads=16,
                           ffn_hidden_size=8192),
    "gpt2-xl": GPTConfig(hidden_size=1600, num_layers=48, num_heads=25,
                         ffn_hidden_size=6400),
}


def _lora_delta(x, ids, A, B):
    """Per-row paged-LoRA delta, ``paddle_tpu/models/gpt.py:98``'s
    counterpart: gather each batch row's adapter page from the stacked
    pool factors (``A [pages, din, r]`` / ``B [pages, r, dout]``) and
    apply ``x @ A_page @ B_page``, two thin products. ``ids`` is the
    per-row int64 page vector; page 0 is the all-zero base page, so base
    rows add an exact zero. The reference computes this in jnp outside
    any Pallas kernel, so it is plain PyTorch here too."""
    return torch.bmm(torch.bmm(x, A.index_select(0, ids)),
                     B.index_select(0, ids))


def _out_std(cfg: GPTConfig) -> float:
    # residual-branch output projections shrink with depth (GPT-2)
    return cfg.init_std / math.sqrt(2.0 * cfg.num_layers)


class GPTAttention(nn.Module):
    """Causal self-attention: fused qkv projection + attention."""

    def __init__(self, cfg: GPTConfig, *, device, generator):
        super().__init__()
        self.cfg = cfg
        self.qkv_proj = Linear(cfg.hidden_size, 3 * cfg.hidden_size,
                               std=cfg.init_std, device=device,
                               generator=generator)
        self.out_proj = Linear(cfg.hidden_size, cfg.hidden_size,
                               std=_out_std(cfg), device=device,
                               generator=generator)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, cache=None, cache_pos=None, block_tables=None,
                lora=None, *, attn_impl=None):
        """``lora`` is ``(page_ids [b] int64, Aq, Bq, Ao, Bo)``, this
        layer's slice of the paged adapter pool: the qkv and output
        projections gain their rows' deltas."""
        cfg = self.cfg
        b, s, _ = x.shape
        qkv = self.qkv_proj(x)
        if lora is not None:
            qkv = qkv + _lora_delta(x, lora[0], lora[1], lora[2])
        qkv = qkv.reshape(b, s, 3, cfg.num_heads, cfg.head_dim)
        qkv = qkv.permute(2, 0, 3, 1, 4)                 # [3, b, h, s, d]
        q, k, v = qkv[0], qkv[1], qkv[2]
        scale = 1.0 / math.sqrt(cfg.head_dim)
        if block_tables is not None:
            out, cache = self._paged(q, k, v, cache, cache_pos,
                                     block_tables, attn_impl, scale)
        elif cache is not None and cache_pos is not None:
            out, cache = self._slotted(q, k, v, cache, cache_pos, scale)
        else:
            if cache is not None:                    # the concat cache
                k = torch.cat([cache[0], k], dim=2)
                v = torch.cat([cache[1], v], dim=2)
                cache = (k, v)
            out = fused_attention_qkv(q, k, v, causal=True, scale=scale)
        out = out.transpose(1, 2).reshape(b, s, cfg.hidden_size)
        y = self.out_proj(out)
        if lora is not None:
            y = y + _lora_delta(out, lora[0], lora[3], lora[4])
        out = self.dropout(y)
        return out if cache is None else (out, cache)

    def _slotted(self, q, k, v, cache, cache_pos, scale):
        """Fixed-capacity cache: ``cache`` is a (k, v) pair of [b, h,
        capacity, d] tensors, written in place at each row's offset
        ``cache_pos`` (an int or a [b] tensor) by
        :func:`~paddle_tpu_torch.ops.attention_ops.cache_scatter_write`.
        The same branch serves prefill (s = the bucket), decode (s = 1)
        and the speculative verify (s = K+1): the position mask lets
        query i see keys ``j <= pos + i`` only."""
        b = q.shape[0]
        pos = torch.as_tensor(cache_pos, dtype=torch.int32, device=q.device)
        if pos.dim() == 0:
            pos = pos.expand(b)
        kc = cache_scatter_write(cache[0], k, pos)
        vc = cache_scatter_write(cache[1], v, pos)
        mask = decode_attention_mask(pos, q.shape[2], kc.shape[2], kc.dtype)
        out = fused_attention_qkv(q, kc, vc, mask=mask, causal=False,
                                  scale=scale)
        return out, (kc, vc)

    def _paged(self, q, k, v, cache, cache_pos, block_tables, attn_impl,
               scale):
        """Block-paged KV cache: ``cache`` is a (k, v) pool pair of
        [num_blocks, h, block_size, d] blocks shared by every request,
        or a 4-wide (k codes, v codes, k scales, v scales) int8 layer;
        each batch row's positions route through its ``block_tables``
        row. The new keys and values are written in place; an int8
        layer returns a 5th element, the max abs dequantization error
        of the rows just written."""
        b, _, s, _ = q.shape
        pos = torch.as_tensor(cache_pos, dtype=torch.int32, device=q.device)
        if pos.dim() == 0:
            pos = pos.expand(b)
        pos = pos.contiguous()
        tables = torch.as_tensor(block_tables, dtype=torch.int32,
                                 device=q.device).contiguous()
        if len(cache) >= 4:
            kp, vp, ksc, vsc = cache[:4]
            kp, ksc, kerr = block_scatter_write_quant(kp, ksc, k, pos, tables)
            vp, vsc, verr = block_scatter_write_quant(vp, vsc, v, pos, tables)
            cache = (kp, vp, ksc, vsc, torch.maximum(kerr, verr))
        else:
            kp, vp = cache[0], cache[1]
            ksc = vsc = None
            block_scatter_write(kp, k, pos, tables)
            block_scatter_write(vp, v, pos, tables)
            cache = (kp, vp)
        impl = attn_impl or _flags.get_flag("serving_attn_impl")
        if impl == "kernel":
            out = paged_attention(q.contiguous(), kp, vp, tables, pos,
                                  k_scale=ksc, v_scale=vsc, scale=scale)
        elif impl == "composed":
            if ksc is not None:
                kg = block_gather_dequant(kp, ksc, tables)
                vg = block_gather_dequant(vp, vsc, tables)
            else:
                kg = block_gather(kp, tables)            # [b, h, T*bs, d]
                vg = block_gather(vp, tables)
            mask = decode_attention_mask(pos, s, kg.shape[2], kg.dtype)
            out = _composed_attention(q, kg, vg, mask, causal=False,
                                      scale=scale)
        else:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{impl!r}")
        return out, cache


class GPTBlock(nn.Module):
    def __init__(self, cfg: GPTConfig, *, device, generator):
        super().__init__()
        self.ln1 = LayerNorm(cfg.hidden_size, device=device)
        self.attn = GPTAttention(cfg, device=device, generator=generator)
        self.ln2 = LayerNorm(cfg.hidden_size, device=device)
        self.fc1 = Linear(cfg.hidden_size, cfg.ffn_hidden_size,
                          std=cfg.init_std, device=device,
                          generator=generator)
        self.fc2 = Linear(cfg.ffn_hidden_size, cfg.hidden_size,
                          std=_out_std(cfg), device=device,
                          generator=generator)
        self.dropout = Dropout(cfg.dropout)

    def forward(self, x, cache=None, cache_pos=None, block_tables=None,
                lora=None, *, attn_impl=None):
        # lora = (page_ids [b], this layer's 8 pool factors (Aq, Bq, Ao,
        # Bo, A1, B1, A2, B2)): attention takes the first four, the MLP
        # pair the rest
        attn_lora = None
        if lora is not None:
            ids, arrs = lora
            attn_lora = (ids,) + tuple(arrs[:4])
        if cache is None:
            x = F.add(x, self.attn(self.ln1(x)))
        else:
            a, cache = self.attn(self.ln1(x), cache, cache_pos=cache_pos,
                                 block_tables=block_tables,
                                 attn_impl=attn_impl, lora=attn_lora)
            x = F.add(x, a)
        h = self.ln2(x)
        f = self.fc1(h)
        if lora is not None:
            f = f + _lora_delta(h, ids, arrs[4], arrs[5])
        g = F.gelu(f, approximate=True)
        o = self.fc2(g)
        if lora is not None:
            o = o + _lora_delta(g, ids, arrs[6], arrs[7])
        x = F.add(x, self.dropout(o))
        return x if cache is None else (x, cache)


class GPTModel(nn.Module):
    """Embeddings + pre-LN decoder stack + final LN."""

    def __init__(self, cfg: GPTConfig, *, device, generator):
        super().__init__()
        self.cfg = cfg
        self.wte = Embedding(cfg.padded_vocab_size, cfg.hidden_size,
                             std=cfg.init_std, device=device,
                             generator=generator)
        self.wpe = Embedding(cfg.max_position_embeddings, cfg.hidden_size,
                             std=cfg.init_std, device=device,
                             generator=generator)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(
            [GPTBlock(cfg, device=device, generator=generator)
             for _ in range(cfg.num_layers)])
        self.ln_f = LayerNorm(cfg.hidden_size, device=device)

    def forward(self, input_ids, cache=None, position_offset=0,
                cache_pos=None, block_tables=None, lora=None, *,
                attn_impl=None):
        """``lora`` (cache branches only) is ``(page_ids [b], the 8
        stacked [layers, pages, ...] pool factors)``, each block taking
        its own layer."""
        s = input_ids.shape[1]
        dev = input_ids.device
        if lora is not None:
            lora = (torch.as_tensor(lora[0], device=dev).long(),
                    tuple(lora[1]))
        maxpos = self.cfg.max_position_embeddings
        if cache_pos is not None:
            if isinstance(cache_pos, int) and cache_pos + s > maxpos:
                raise ValueError(
                    f"sequence length {cache_pos + s} exceeds "
                    f"max_position_embeddings={maxpos}")
            p = torch.as_tensor(cache_pos, dtype=torch.int64, device=dev)
            p = p[None] if p.dim() == 0 else p
            # clamp: bucketed-prefill padding rows carry positions past
            # a short request's length; an out-of-range row of wpe is a
            # device assert on CUDA. The clamp is an identity for every
            # valid row (callers keep real positions < maxpos).
            pos = torch.clamp_max(
                p[:, None] + torch.arange(s, device=dev)[None], maxpos - 1)
        else:
            if position_offset + s > maxpos:
                raise ValueError(
                    f"sequence length {position_offset + s} exceeds "
                    f"max_position_embeddings={maxpos}; raise it in the "
                    "GPTConfig or truncate the input")
            pos = torch.arange(position_offset, position_offset + s,
                               device=dev)[None]
        x = self.drop(F.add(self.wte(input_ids), self.wpe(pos)))
        new_caches = []
        for i, blk in enumerate(self.blocks):
            if cache is None:
                x = self._recomputed(blk, x) if self.cfg.recompute \
                    else blk(x)
            else:
                x, c = blk(x, cache[i], cache_pos=cache_pos,
                           block_tables=block_tables, attn_impl=attn_impl,
                           lora=None if lora is None else
                           (lora[0], tuple(a[i] for a in lora[1])))
                new_caches.append(c)
        x = self.ln_f(x)
        return x if cache is None else (x, new_caches)

    def _recomputed(self, blk, x):
        """``blk(x)`` keeping only ``x`` for the backward pass, which
        recomputes the block under the AMP state of this forward."""
        replay_rng = self.training and self.cfg.dropout > 0
        if replay_rng and capturing():
            raise NotImplementedError(
                "GPTConfig.recompute with dropout > 0 cannot be captured "
                "in a CUDA graph: the recomputation replays the forward's "
                "dropout masks from the saved RNG state, which a capture "
                "does not allow; use dropout 0 or recompute=False under "
                "jit.to_static")
        state = amp_state()

        def run(inp):
            with amp_state_guard(state):
                return blk(inp)

        return torch.utils.checkpoint.checkpoint(
            run, x, use_reentrant=False, preserve_rng_state=replay_rng)

    def gen_cache(self, batch_size):
        """Empty concat cache: per layer a (k, v) pair of [b, h, 0, d]."""
        cfg = self.cfg
        shape = (batch_size, cfg.num_heads, 0, cfg.head_dim)
        dev = self.wte.weight.device
        return [tuple(torch.zeros(shape, device=dev) for _ in range(2))
                for _ in range(cfg.num_layers)]

    def gen_fixed_cache(self, batch_size, max_len):
        """Zeroed fixed-capacity cache on the model's device: per layer a
        (k, v) pair of [b, h, max_len, d] f32, used with ``cache_pos`` so
        every decode step has one shape. Each tensor is its own: the
        forward writes them in place, where the reference shares one
        immutable zero array."""
        cfg = self.cfg
        shape = (batch_size, cfg.num_heads, max_len, cfg.head_dim)
        dev = self.wte.weight.device
        return [tuple(torch.zeros(shape, device=dev) for _ in range(2))
                for _ in range(cfg.num_layers)]

    def gen_block_pool(self, num_blocks, block_size, kv_dtype="f32"):
        """Zeroed block-paged KV pool on the model's device: per layer a
        (k, v) pair of [num_blocks, h, block_size, d], or for 'int8' the
        4-wide (k codes, v codes, k scales, v scales) layer with
        [num_blocks, h] f32 scales. Block 0 is the serving plane's trash
        block."""
        cfg = self.cfg
        dev = self.wte.weight.device
        shape = (num_blocks, cfg.num_heads, block_size, cfg.head_dim)
        pools = []
        for _ in range(cfg.num_layers):
            if kv_dtype == "int8":
                sshape = (num_blocks, cfg.num_heads)
                pools.append((torch.zeros(shape, dtype=torch.int8, device=dev),
                              torch.zeros(shape, dtype=torch.int8, device=dev),
                              torch.zeros(sshape, device=dev),
                              torch.zeros(sshape, device=dev)))
            else:
                dt = {"f32": torch.float32, "bf16": torch.bfloat16}[kv_dtype]
                pools.append((torch.zeros(shape, dtype=dt, device=dev),
                              torch.zeros(shape, dtype=dt, device=dev)))
        return pools


class GPTForCausalLM(nn.Module):
    """LM head tied to the token embedding (weight sharing, like GPT-2).

    ``device=None`` means CUDA and raises without one; parameters are
    drawn from ``generator`` (default: a generator on ``device`` seeded
    with 0), which must live on ``device``."""

    def __init__(self, cfg: GPTConfig, *, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        generator = resolve_generator(device, generator)
        self.cfg = cfg
        self.gpt = GPTModel(cfg, device=device, generator=generator)

    @property
    def device(self) -> torch.device:
        return self.gpt.wte.weight.device

    def forward(self, input_ids, labels=None, cache=None, position_offset=0,
                cache_pos=None, block_tables=None, lora=None, *,
                attn_impl=None):
        """Logits ``[b, s, vocab]`` (with the updated cache when one is
        given), or with ``labels`` (``[b, s]`` ids aligned with the
        logits, not shifted; -100 ignored) the mean cross-entropy loss,
        as ``paddle_tpu/models/gpt.py:459-463``."""
        if cache is None:
            h = self.gpt(input_ids, position_offset=position_offset)
        else:
            h, cache = self.gpt(input_ids, cache, position_offset,
                                cache_pos=cache_pos,
                                block_tables=block_tables,
                                attn_impl=attn_impl, lora=lora)
        h, w = autocast_inputs("matmul_v2", h, self.gpt.wte.weight)
        logits = h @ w.T                                 # tied LM head
        if self.cfg.padded_vocab_size != self.cfg.vocab_size:
            logits = logits[:, :, :self.cfg.vocab_size]
        if labels is not None:
            return F.cross_entropy(
                logits.reshape(-1, self.cfg.vocab_size),
                labels.reshape(-1, 1), ignore_index=-100)
        return logits if cache is None else (logits, cache)
