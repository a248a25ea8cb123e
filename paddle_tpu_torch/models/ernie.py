"""ERNIE — the bidirectional-encoder family (masked-LM pretraining): the
counterpart of ``paddle_tpu/models/ernie.py``.

Token + position (+ optional segment) embeddings, a post-LN
:class:`~paddle_tpu_torch.nn.transformer.TransformerEncoder` with exact
GELU, a tanh pooler over the first token, an MLM head tied to the word
embedding and a sentence-order head. The module tree and the structured
parameter names are the JAX model's (``ernie.embeddings.word_embeddings.
weight``, ``ernie.encoder.layers.<i>.self_attn.q_proj.weight``, ...), so
weights carry across by name (:mod:`.convert`). The ops cast under AMP
as the reference's do: under ``auto_cast(level="O2")`` the LayerNorms
and the losses run in f32 (and reach the fused LayerNorm kernels when
``use_pallas_layer_norm`` is on and ``h % 128 == 0``), the rest in bf16.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..amp.auto_cast import maybe_autocast_inputs
from ..device import resolve_device, resolve_generator
from ..nn import functional as F
from ..nn.layers_common import Embedding, LayerNorm, Linear
from ..nn.transformer import TransformerEncoder, TransformerEncoderLayer


@dataclass
class ErnieConfig:
    vocab_size: int = 18000
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1


ERNIE_CONFIGS = {
    "ernie-tiny": ErnieConfig(vocab_size=1000, hidden_size=64,
                              num_hidden_layers=2, num_attention_heads=4,
                              intermediate_size=256,
                              max_position_embeddings=128),
    "ernie-base": ErnieConfig(),
    "ernie-3.0-medium": ErnieConfig(hidden_size=768,
                                    num_hidden_layers=6),
    "ernie-3.0-xbase": ErnieConfig(hidden_size=1024,
                                   num_hidden_layers=20,
                                   num_attention_heads=16,
                                   intermediate_size=4096),
}


def _placement(device, generator):
    """``device=None`` means CUDA and raises without one; parameters are
    drawn from ``generator`` (default: one on ``device`` seeded with
    0)."""
    device = resolve_device(device)
    return device, resolve_generator(device, generator)


class ErnieEmbeddings(nn.Module):
    def __init__(self, cfg: ErnieConfig, *, device, generator):
        super().__init__()
        init = dict(device=device, generator=generator)
        self.max_positions = cfg.max_position_embeddings
        self.word_embeddings = Embedding(cfg.vocab_size, cfg.hidden_size,
                                         **init)
        self.position_embeddings = Embedding(cfg.max_position_embeddings,
                                             cfg.hidden_size, **init)
        self.token_type_embeddings = Embedding(cfg.type_vocab_size,
                                               cfg.hidden_size, **init)
        self.layer_norm = LayerNorm(cfg.hidden_size, device=device)

    def forward(self, input_ids, token_type_ids=None):
        seq = input_ids.shape[1]
        if seq > self.max_positions:
            raise ValueError(f"sequence length {seq} exceeds "
                             f"max_position_embeddings={self.max_positions}")
        pos = torch.arange(seq, dtype=torch.int32,
                           device=input_ids.device)[None]
        x = F.add(self.word_embeddings(input_ids),
                  self.position_embeddings(pos))
        if token_type_ids is not None:
            x = F.add(x, self.token_type_embeddings(token_type_ids))
        return self.layer_norm(x)


class ErnieModel(nn.Module):
    """Encoder trunk: embeddings -> TransformerEncoder -> (sequence
    output, pooled output of the first token)."""

    def __init__(self, cfg: ErnieConfig, device=None, generator=None):
        super().__init__()
        device, generator = _placement(device, generator)
        init = dict(device=device, generator=generator)
        self.cfg = cfg
        self.embeddings = ErnieEmbeddings(cfg, **init)
        enc_layer = TransformerEncoderLayer(
            d_model=cfg.hidden_size, nhead=cfg.num_attention_heads,
            dim_feedforward=cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation="gelu",
            attn_dropout=cfg.attention_probs_dropout_prob, **init)
        self.encoder = TransformerEncoder(enc_layer, cfg.num_hidden_layers)
        self.pooler = Linear(cfg.hidden_size, cfg.hidden_size, **init)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        """``attention_mask`` only hides padding: a ``[b, s]`` 0/1 keep
        mask becomes the additive ``(keep - 1) * 1e4`` of shape ``[b, 1,
        1, s]`` (cast as the reference's ``unsqueeze2`` casts it); any
        other mask is taken as additive and passed through."""
        x = self.embeddings(input_ids, token_type_ids)
        if attention_mask is not None and attention_mask.dim() == 2:
            (keep,) = maybe_autocast_inputs(
                "unsqueeze2", attention_mask.to(torch.float32))
            attention_mask = (keep[:, None, None, :] - 1.0) * 1e4
        x = self.encoder(x, src_mask=attention_mask)
        return x, F.tanh(self.pooler(x[:, 0]))


class ErnieForPretraining(nn.Module):
    """MLM head tied to the word embedding plus the sentence-order head;
    with ``masked_lm_labels`` (-100 ignored) returns the MLM
    cross-entropy, plus the SOP cross-entropy when
    ``next_sentence_label`` is given, else ``(logits, ns_logits)``."""

    def __init__(self, cfg: ErnieConfig, device=None, generator=None):
        super().__init__()
        device, generator = _placement(device, generator)
        init = dict(device=device, generator=generator)
        self.ernie = ErnieModel(cfg, **init)
        self.transform = Linear(cfg.hidden_size, cfg.hidden_size, **init)
        self.transform_ln = LayerNorm(cfg.hidden_size, device=device)
        self.seq_relationship = Linear(cfg.hidden_size, 2, **init)
        self.cfg = cfg

    @property
    def device(self) -> torch.device:
        return self.transform.weight.device

    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                masked_lm_labels=None, next_sentence_label=None):
        seq_out, pooled = self.ernie(input_ids, token_type_ids,
                                     attention_mask)
        h = self.transform_ln(F.gelu(self.transform(seq_out)))
        logits = F.matmul(h, self.ernie.embeddings.word_embeddings.weight.T)
        ns_logits = self.seq_relationship(pooled)
        if masked_lm_labels is None:
            return logits, ns_logits
        loss = F.cross_entropy(logits.reshape(-1, self.cfg.vocab_size),
                               masked_lm_labels.reshape(-1, 1),
                               ignore_index=-100)
        if next_sentence_label is not None:
            loss = F.add(loss, F.cross_entropy(
                ns_logits, next_sentence_label.reshape(-1, 1)))
        return loss


class ErnieForSequenceClassification(nn.Module):
    """A linear classifier over the pooled output."""

    def __init__(self, cfg: ErnieConfig, num_classes: int = 2, device=None,
                 generator=None):
        super().__init__()
        device, generator = _placement(device, generator)
        self.ernie = ErnieModel(cfg, device=device, generator=generator)
        self.classifier = Linear(cfg.hidden_size, num_classes, device=device,
                                 generator=generator)

    def forward(self, input_ids, token_type_ids=None, attention_mask=None):
        _, pooled = self.ernie(input_ids, token_type_ids, attention_mask)
        return self.classifier(pooled)
