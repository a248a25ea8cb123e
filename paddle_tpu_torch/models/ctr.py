"""CTR model family: Wide&Deep and DeepFM over sparse id slots — the
counterpart of ``paddle_tpu/models/ctr.py``.

Both models consume padded slot-id batches ``[b, slots]`` (or ``[b,
slots, k]`` multi-hot with 0 padding). Two execution tiers, as in the
reference:

- the eager classes (:class:`WideDeep`, :class:`DeepFM`) keep the
  embedding on the device;
- :func:`build_wide_deep_program` emits the STATIC parameter-server
  program whose embedding rows come from host sparse tables
  (``host_paced=True``: the rows are dense feeds, their ``@GRAD``s
  fetched and pushed by :func:`~paddle_tpu_torch.distributed.ps.run_host_paced`).
  The in-graph transport (``host_paced=False``, the
  ``distributed_lookup_table`` op's host callback inside the compiled
  step) waits for ROADMAP A7.4.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device, resolve_generator
from ..nn import functional as F
from ..nn.layers_common import Embedding, Linear

#: the CTR tables' N(0, 0.01²) init (the reference's ``_small_init``)
SMALL_STD = 0.01


class _SlotEmbedding(nn.Module):
    """One table shared by all slots; multi-hot slots sum-pool over k,
    padding id 0 embedding to zeros."""

    def __init__(self, vocab_size: int, dim: int, *, device, generator):
        super().__init__()
        self.embedding = Embedding(vocab_size, dim, padding_idx=0,
                                   std=SMALL_STD, device=device,
                                   generator=generator)

    def forward(self, ids):
        emb = self.embedding(ids)             # [b, slots(, k), dim]
        if ids.dim() == 3:
            emb = emb.sum(dim=2)              # pool the k hot ids
        return emb                            # [b, slots, dim]


def _embed(self, vocab_size, embed_dim, device, generator):
    """The slot embedding both models open with (their order-1 table,
    then :func:`_make_deep`'s tower and head follow, the reference's
    order). Returns the parameters' device and generator."""
    device = resolve_device(device)
    kw = dict(device=device, generator=resolve_generator(device, generator))
    self.embed = _SlotEmbedding(vocab_size, embed_dim, **kw)
    return kw


def _make_deep(self, embed_dim, num_slots, hidden_sizes, kw):
    dims = [num_slots * embed_dim] + list(hidden_sizes)
    self.deep = nn.ModuleList([Linear(a, b, **kw)
                               for a, b in zip(dims[:-1], dims[1:])])
    self.head = Linear(dims[-1], 1, **kw)


def _run_deep(self, emb):
    """The deep tower (relu after each layer) and the head over ``emb``
    ``[b, slots, dim]``."""
    deep = emb.reshape(emb.shape[0], -1)
    for fc in self.deep:
        deep = F.relu(fc(deep))
    return self.head(deep)


class WideDeep(nn.Module):
    """Wide & Deep: a linear (order-1) wide part over the same ids plus an
    MLP deep tower over the concatenated slot embeddings. Parameters are
    drawn from ``generator`` (seeded 0 on ``device`` by default), not the
    reference's stream; carry weights across by name."""

    def __init__(self, vocab_size: int = 100000, embed_dim: int = 8,
                 num_slots: int = 8,
                 hidden_sizes: Sequence[int] = (64, 32), *, device=None,
                 generator: torch.Generator = None):
        super().__init__()
        kw = _embed(self, vocab_size, embed_dim, device, generator)
        self.wide = Embedding(vocab_size, 1, padding_idx=0, std=SMALL_STD,
                              **kw)
        _make_deep(self, embed_dim, num_slots, hidden_sizes, kw)

    def forward(self, slot_ids):
        b = slot_ids.shape[0]
        emb = self.embed(slot_ids)                   # [b, s, d]
        wide = self.wide(slot_ids).reshape(b, -1)    # [b, s(*k)]
        return _run_deep(self, emb) + wide.sum(dim=-1, keepdim=True)


class DeepFM(nn.Module):
    """DeepFM: order-1 + the pairwise FM interaction (the sum-square
    trick) + the deep tower, sharing one embedding."""

    def __init__(self, vocab_size: int = 100000, embed_dim: int = 8,
                 num_slots: int = 8,
                 hidden_sizes: Sequence[int] = (64, 32), *, device=None,
                 generator: torch.Generator = None):
        super().__init__()
        kw = _embed(self, vocab_size, embed_dim, device, generator)
        self.first_order = Embedding(vocab_size, 1, padding_idx=0,
                                     std=SMALL_STD, **kw)
        _make_deep(self, embed_dim, num_slots, hidden_sizes, kw)

    def forward(self, slot_ids):
        b = slot_ids.shape[0]
        emb = self.embed(slot_ids)                   # [b, s, d]
        # FM second order: 0.5 * ((sum_i v_i)^2 - sum_i v_i^2)
        sum_v = emb.sum(dim=1)                       # [b, d]
        sum_sq = (emb * emb).sum(dim=1)
        fm = 0.5 * (sum_v * sum_v - sum_sq).sum(dim=-1, keepdim=True)
        first = self.first_order(slot_ids).reshape(b, -1) \
            .sum(dim=-1, keepdim=True)
        return _run_deep(self, emb) + fm + first


def build_wide_deep_program(num_slots: int = 8, embed_dim: int = 8,
                            hidden_sizes: Sequence[int] = (64, 32),
                            table_name: str = "ctr_embedding",
                            sparse_lr: float = 0.1,
                            dense_lr: float = 0.01,
                            host_paced: bool = False):
    """Static PS-tier Wide&Deep: the sparse embedding on host tables, the
    dense tower trained with SGD on the device, the program of
    ``bench.py``'s ``widedeep`` config. ``host_paced=True`` makes the
    rows plain DENSE feed vars (``ctr_emb`` ``[b, slots, embed]``,
    ``ctr_wide`` ``[b, slots, 1]``, stop_gradient=False) whose gradients
    are fetchable ``@GRAD`` vars; ``host_paced=False`` (the in-graph
    ``distributed_lookup_table``) raises NotImplementedError naming
    ROADMAP A7.4.

    Returns (main, startup, loss_var, logit_var); feed ``ids``
    [b, num_slots] int64 and ``label`` [b, 1] float32 plus the two row
    feeds.
    """
    if not host_paced:
        raise NotImplementedError(
            "build_wide_deep_program(host_paced=False): the in-graph "
            "distributed_lookup_table transport waits for ROADMAP A7.4")
    from .. import layers as L
    from ..framework import Program, program_guard, unique_name
    from ..optimizer import SGD

    main, startup = Program(), Program()
    with program_guard(main, startup), unique_name.guard():
        L.data("ids", [num_slots], dtype="int64")
        label = L.data("label", [1])
        emb = L.data("ctr_emb", [num_slots, embed_dim])
        emb.stop_gradient = False
        deep = L.reshape(emb, [-1, num_slots * embed_dim])
        for h in hidden_sizes:
            deep = L.fc(deep, h, act="relu")
        deep_logit = L.fc(deep, 1)
        # wide order-1 path: its own dim-1 table summed straight into
        # the logit
        wide = L.data("ctr_wide", [num_slots, 1])
        wide.stop_gradient = False
        wide_sum = L.reduce_sum(wide, dim=[1])
        logit = L.elementwise_add(deep_logit, wide_sum)
        loss = L.reduce_mean(
            L.sigmoid_cross_entropy_with_logits(logit, label))
        SGD(learning_rate=dense_lr).minimize(loss)
    return main, startup, loss, logit


__all__ = ["DeepFM", "WideDeep", "build_wide_deep_program"]
