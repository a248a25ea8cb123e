"""Per-request decoding — the counterpart of the greedy core of
``paddle_tpu/serving/decoding.py``: the :class:`DecodeParams` recipe,
the greedy branch of :func:`sample_tokens`, the incremental
stop-sequence matcher and its device tables, which the decode megastep
advances inside its graph.

Sampled decoding (temperature > 0) is not ported: the JAX package draws
from a per-request threefry stream, which only a port of threefry can
reproduce, so the engine rejects such requests with
NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


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


def sample_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next token per row from ``[rows, vocab]`` logits: the
    first index of the maximum (``torch.argmax`` and ``jnp.argmax``
    both break ties toward the lower index). Returns int32 [rows]."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


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
