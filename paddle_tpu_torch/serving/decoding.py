"""Per-request decoding — the counterpart of ``paddle_tpu/serving/
decoding.py`` but its JSON grammar: the :class:`DecodeParams` recipe, the
sampling chain the compiled steps run (temperature, top-k, top-p, a
per-request threefry stream, rejection-sampled speculative verify), the
incremental stop-sequence matcher and its device tables, which the
decode megastep advances inside its graph.

A request's random stream is a threefry key (:mod:`paddle_tpu_torch.prng`,
bit-equal to ``jax.random``) derived from its seed alone and split once
per step it samples in, so a sampled request draws the same tokens in any
batch, slot or engine, and the same as the JAX engine does.

The sampled steps take the ``samp`` tuple ``(temperature [b] f32,
top_k [b] i32, top_p [b] f32, keys [b, 2] int64, mask [b, V] f32)``: the
reference's, with keys held as int64 values in [0, 2^32) and the mask
an all-zero device buffer, since no grammar writes it. Where every row
of a batch is greedy, the engine runs the greedy graph instead, which
takes no ``samp`` (see ``models/generation.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import prng

# Additive-mask value for banned tokens: softmax gives them exactly 0 in
# f32, and dividing it by any temperature the validator admits stays
# finite.
NEG_MASK = -1e9


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    """Per-request decoding parameters, carried on ``Request``.

    temperature == 0 is greedy (the default). ``stop_sequences`` are
    token-id suffixes checked host-side after every committed token
    (the stop tokens stay in the output). Validation matches the JAX
    package field for field.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()
    seed: int = 0
    json_mode: bool = False

    def __post_init__(self):
        t = self.temperature
        if not (isinstance(t, (int, float)) and np.isfinite(t)) or t < 0:
            raise ValueError(
                f"temperature must be a finite float >= 0, got {t!r}")
        if not isinstance(self.top_k, int) or isinstance(self.top_k, bool) \
                or self.top_k < 0:
            raise ValueError(
                f"top_k must be an int >= 0 (0 disables), got "
                f"{self.top_k!r}")
        p = self.top_p
        if not (isinstance(p, (int, float)) and np.isfinite(p)) \
                or not (0.0 <= p <= 1.0):
            raise ValueError(
                f"top_p must be in [0, 1] (0 or 1 disables), got {p!r}")
        if not isinstance(self.seed, int) or isinstance(self.seed, bool):
            raise ValueError(f"seed must be an int, got {self.seed!r}")
        stops = []
        for s in self.stop_sequences:
            s = tuple(s)
            if not s or not all(isinstance(t, (int, np.integer))
                                for t in s):
                raise ValueError(
                    "stop_sequences must be non-empty sequences of "
                    f"token ids, got {s!r}")
            stops.append(tuple(int(t) for t in s))
        object.__setattr__(self, "stop_sequences", tuple(stops))
        if not isinstance(self.json_mode, bool):
            raise ValueError(
                f"json_mode must be a bool, got {self.json_mode!r}")

    @property
    def is_greedy(self) -> bool:
        return self.temperature == 0.0

    @property
    def is_default(self) -> bool:
        """Plain greedy, no stops, no grammar."""
        return (self.is_greedy and not self.stop_sequences
                and not self.json_mode)


def request_key(seed: int) -> np.ndarray:
    """The request-local PRNG root, a raw ``[2] uint32`` threefry key
    (``jax.random.PRNGKey(seed)``), derived from the seed alone — never
    from the slot or the engine — so a restart replays the stream."""
    return prng.PRNGKey(seed).numpy().astype(np.uint32)


def neutral_samp(rows: int, vocab: int):
    """Per-slot sampling inputs that reproduce pure greedy decoding
    (temperature 0 on every row, a zero mask), as numpy arrays; keys are
    uint32 as the reference's."""
    return (np.zeros((rows,), np.float32),
            np.zeros((rows,), np.int32),
            np.zeros((rows,), np.float32),
            np.zeros((rows, 2), np.uint32),
            np.zeros((rows, vocab), np.float32))


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next token per row from ``[rows, vocab]`` logits: the
    first index of the maximum (``torch.argmax`` and ``jnp.argmax``
    both break ties toward the lower index). Returns int32 [rows]."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def process_logits(logits, temp, top_k, top_p):
    """The logit-processor chain: temperature, then top-k, then top-p,
    on ``[rows, vocab]`` logits with per-row parameters. 0 disables
    top-k; 0 or 1 disables top-p. Rows with temperature 0 are scaled by
    1 (their caller takes the argmax); filtered entries drop to
    ``NEG_MASK``. Top-k keeps the logits at or above the k-th largest
    (from an ascending sort); top-p keeps the entries whose *exclusive*
    cumulative probability, in descending order (a stable sort, ties by
    index), is below p, so the top token always survives."""
    v = logits.shape[-1]
    scale = torch.where(temp > 0, temp, torch.ones_like(temp))
    lg = logits / scale.to(logits.dtype)[:, None]
    kk = torch.clamp(top_k, 0, v)
    srt = torch.sort(lg, dim=-1).values                 # ascending
    kth = torch.gather(srt, -1, torch.clamp(v - kk, 0, v - 1)
                       .long()[:, None])
    lg = torch.where((kk <= 0)[:, None] | (lg >= kth), lg, NEG_MASK)
    active = ((top_p > 0) & (top_p < 1))[:, None]
    neg_sorted, order = torch.sort(-lg, dim=-1, stable=True)
    probs = torch.softmax(-neg_sorted, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep_sorted = (csum - probs) < top_p[:, None]
    keep = torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
    return torch.where(active & ~keep, NEG_MASK, lg)


def split_keys(keys):
    """Advance per-row keys one step: ``[rows, 2] -> (carry, sub)``, one
    split per row, whatever the data (the determinism contract)."""
    pairs = prng.split(keys, 2)
    return pairs[:, 0], pairs[:, 1]


def sample_tokens(logits, samp):
    """One next token per row from ``[rows, vocab]`` logits. ``samp =
    (temperature, top_k, top_p, keys, mask)``. Returns ``(tokens [rows]
    i32, carry_keys [rows, 2] int64)``. Greedy rows (temperature 0) take
    ``argmax(logits + mask)``; sampled rows draw from the processed
    logits with their key's sub-key. Every row's key is split."""
    temp, top_k, top_p, keys, mask = samp
    lgm = logits + mask
    greedy = greedy_tokens(lgm)
    proc = process_logits(lgm, temp, top_k, top_p)
    carry, sub = split_keys(keys)
    drawn = prng.categorical(sub, proc).to(torch.int32)
    return torch.where(temp > 0, drawn, greedy), carry


def verify_tokens(logits, drafts, samp):
    """Rejection-sampled speculative verify over ``K+1`` positions:
    ``logits [rows, K+1, vocab]``, ``drafts [rows, K]``. Returns
    ``(chosen [rows, K+1] i32, accept [rows, K] bool, carry_keys)``.
    Position i's law is the softmax of the processed logits; the n-gram
    drafter is deterministic, so a draft is accepted with probability
    ``p_i(draft)`` (a uniform below it) and a rejection draws from
    ``p_i`` with the draft masked out; the bonus position draws from
    ``p_K``. Each row splits its sub-key into a fixed fan-out of 2(K+1):
    K+1 accept draws and K+1 token draws, used or not. Greedy rows take
    the argmax and accept where it equals the draft. Entries past a
    row's first rejection are garbage; the engine commits the accepted
    prefix."""
    temp, top_k, top_p, keys, mask = samp
    rows, kp1, vocab = logits.shape
    k = kp1 - 1
    lgm = logits + mask[:, None, :]
    greedy = greedy_tokens(lgm)

    def rep(x):          # each row's parameter for each of its positions
        return x[:, None].expand(rows, kp1).reshape(-1)

    proc = process_logits(lgm.reshape(rows * kp1, vocab), rep(temp),
                          rep(top_k), rep(top_p)).reshape(rows, kp1, vocab)
    carry, sub = split_keys(keys)
    subs = prng.split(sub, 2 * kp1)
    ukeys, ckeys = subs[:, :kp1], subs[:, kp1:]
    bonus = prng.categorical(ckeys[:, k], proc[:, k]).to(torch.int32)
    if k == 0:
        chosen = torch.where(temp[:, None] > 0, bonus[:, None], greedy)
        return chosen, torch.zeros((rows, 0), dtype=torch.bool,
                                   device=logits.device), carry
    probs = torch.softmax(proc, dim=-1)
    d = drafts.long()
    draft_p = torch.gather(probs[:, :k], -1, d[..., None])[..., 0]
    u = prng.uniform(ukeys[:, :k])
    accept_s = u < draft_p
    resid = proc[:, :k].scatter(-1, d[..., None], NEG_MASK)
    resample = prng.categorical(ckeys[:, :k], resid).to(torch.int32)
    chosen_s = torch.where(accept_s, drafts.to(torch.int32), resample)
    chosen_s = torch.cat([chosen_s, bonus[:, None]], dim=1)
    sampled = (temp > 0)[:, None]
    chosen = torch.where(sampled, chosen_s, greedy)
    accept = torch.where(sampled, accept_s, greedy[:, :k] == drafts)
    return chosen, accept, carry


def sample_first(logits_row, params: DecodeParams, key: np.ndarray):
    """The first token of a sampled request from one prefill logits row
    (a tensor on any device, or an array), through the same
    :func:`sample_tokens` the steps run, with the request's own key.
    Returns ``(token, carry_key [2] uint32)``."""
    lg = torch.as_tensor(logits_row).to(torch.float32)[None, :]
    dev = lg.device
    samp = (torch.full((1,), params.temperature, dtype=torch.float32,
                       device=dev),
            torch.full((1,), params.top_k, dtype=torch.int32, device=dev),
            torch.full((1,), params.top_p, dtype=torch.float32, device=dev),
            torch.as_tensor(np.asarray(key, np.int64), device=dev)[None, :],
            torch.zeros_like(lg))
    tok, carry = sample_tokens(lg, samp)
    return int(tok[0]), carry[0].cpu().numpy().astype(np.uint32)


#: device stop tables hold at most this many patterns per request
STOP_MAX_SEQS = 4
#: ... of at most this many tokens each
STOP_MAX_LEN = 8


def _kmp_fail(pat):
    """KMP failure function as a length ``m+1`` table: ``fail[s]`` is
    the longest proper prefix of ``pat[:s]`` that is also its suffix."""
    m = len(pat)
    fail = [0] * (m + 1)
    k = 0
    for i in range(1, m):
        while k > 0 and pat[i] != pat[k]:
            k = fail[k]
        if pat[i] == pat[k]:
            k += 1
        fail[i + 1] = k
    return fail


class StopMatcher:
    """Incremental host-side stop-sequence matcher for one request: one
    KMP automaton per pattern, ``feed(token)`` O(1) amortized, ``hit``
    latches on the first match (a pattern is then a suffix of the fed
    tokens)."""

    __slots__ = ("patterns", "fails", "states", "hit")

    def __init__(self, stop_sequences: Sequence[Sequence[int]]):
        self.patterns = [tuple(int(t) for t in s) for s in stop_sequences]
        if any(not p for p in self.patterns):
            raise ValueError("stop sequences must be non-empty")
        self.fails = [_kmp_fail(p) for p in self.patterns]
        self.states = [0] * len(self.patterns)
        self.hit = False

    def feed(self, token: int) -> bool:
        """Advance every automaton over one committed token; returns
        (and latches) whether any stop sequence has now matched."""
        tok = int(token)
        for j, pat in enumerate(self.patterns):
            s = self.states[j]
            fail = self.fails[j]
            while s > 0 and (s >= len(pat) or pat[s] != tok):
                s = fail[s]
            s = s + 1 if pat[s] == tok else 0
            self.states[j] = s
            if s == len(pat):
                self.hit = True
        return self.hit

    def feed_all(self, tokens: Sequence[int]) -> bool:
        for t in tokens:
            self.feed(t)
        return self.hit


def stops_fit(stop_sequences: Sequence[Sequence[int]],
              max_seqs: int = STOP_MAX_SEQS,
              max_len: int = STOP_MAX_LEN) -> bool:
    """Whether a request's stop sequences fit the fixed-shape device stop
    tables (the megastep's eligibility check; oversized requests fall
    back to host-side matching at megastep 1)."""
    return (len(stop_sequences) <= max_seqs and
            all(len(s) <= max_len for s in stop_sequences))


def stop_table_rows(matcher: Optional[StopMatcher],
                    max_seqs: int = STOP_MAX_SEQS,
                    max_len: int = STOP_MAX_LEN):
    """One request's device stop tables from its live host matcher:
    ``(pat [J, L] i32, plen [J] i32, fail [J, L+1] i32, state [J] i32)``,
    zero/-1 padded. Pattern rows pad with -1 (no token id is negative, so
    padding never matches); unused pattern slots have ``plen == 0`` and
    never fire in :func:`stops_matched`. ``None`` (no stops) returns the
    inert tables an empty batch slot uses."""
    pat = np.full((max_seqs, max_len), -1, np.int32)
    plen = np.zeros(max_seqs, np.int32)
    fail = np.zeros((max_seqs, max_len + 1), np.int32)
    state = np.zeros(max_seqs, np.int32)
    if matcher is None:
        return pat, plen, fail, state
    if len(matcher.patterns) > max_seqs or \
            any(len(p) > max_len for p in matcher.patterns):
        raise ValueError(
            f"stop sequences exceed the device table caps "
            f"({max_seqs} patterns x {max_len} tokens); gate on "
            "stops_fit() first")
    for j, p in enumerate(matcher.patterns):
        pat[j, :len(p)] = p
        plen[j] = len(p)
        fail[j, :len(p) + 1] = matcher.fails[j]
        state[j] = matcher.states[j]
    return pat, plen, fail, state


def stops_advance(tokens, pat, plen, fail, state):
    """Advance per-slot KMP stop states over one committed token each:
    the device mirror of :meth:`StopMatcher.feed`.

    ``tokens [b]``, ``pat [b, J, L]``, ``plen [b, J]``, ``fail [b, J,
    L+1]``, ``state [b, J]`` (int32 tensors) -> the new ``[b, J]``
    states. The fail-chase, a data-dependent ``while`` on the host, is a
    fixed loop of ``L`` gathers and selects with no host decision, so a
    graph can hold it: each failure transition lowers the state, so
    ``L`` of them always reach the fixpoint. ``plen`` is not read: a
    matched state (``s == plen``) reads the -1 padding at ``pat[s]``
    (clamped into range), which never equals a token, as in the
    reference."""
    L = pat.shape[-1]
    tokb = tokens[:, None]

    def char_at(s):
        idx = torch.clamp_max(s, L - 1).long()[..., None]
        return torch.gather(pat, 2, idx)[..., 0]

    s = state
    for _ in range(L):
        chase = (s > 0) & (char_at(s) != tokb)
        f = torch.gather(fail, 2, s.long()[..., None])[..., 0]
        s = torch.where(chase, f, s)
    return torch.where(char_at(s) == tokb, s + 1, torch.zeros_like(s))


def stops_matched(state, plen):
    """``[b] bool``: whether any real stop pattern of each slot has
    matched (``state == plen`` with ``plen > 0``; unused pattern slots
    sit at plen 0 and never fire)."""
    return torch.any((state == plen) & (plen > 0), dim=1)
