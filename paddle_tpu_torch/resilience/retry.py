"""RetryPolicy — the one retry loop of the port; a copy of
``paddle_tpu/resilience/retry.py``.

Exponential backoff with deterministic jitter and a wall-clock
deadline. The knobs are flags (``FLAGS_retry_*``) and every retry
increments ``STAT_retry_<site>`` so chaos tests can assert the recovery
actually ran. The serving engine retries its ``serving.step`` and
``serving.alloc`` sites through it, the router its ``serving.route``
site (budgeted: :class:`RetryBudget`).
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Dict, Optional, Tuple, Type

from .. import flags as _flags
from .. import monitor as _monitor
from .. import observability as _obs


class RetryError(Exception):
    """Raised when a policy exhausts attempts/deadline; chains the last
    underlying failure (``raise ... from last``)."""


# OSError subclasses that describe the *request*, not the transport —
# retrying them can only waste the deadline hiding a real bug
_NON_TRANSIENT = (FileNotFoundError, FileExistsError, IsADirectoryError,
                  NotADirectoryError, PermissionError)


class RetryBudget:
    """Fleet-wide token bucket bounding *total* retry volume.

    Per-call retry loops amplify correlated failures: when every request
    hits the same fault, each one independently burns its full attempt
    budget and offered load multiplies by ``max_attempts``. The classic
    fix (Google SRE book, "retry budgets") is a shared bucket: every
    *success* anywhere in the fleet deposits ``ratio`` tokens, every
    retry anywhere withdraws one, so retries can add at most ``ratio``
    extra load in steady state. An empty bucket turns would-be retries
    into immediate :class:`RetryError` — correlated failure sheds as
    backpressure instead of storming.

    The bucket starts at ``reserve`` tokens (so isolated early failures
    still retry before any successes have funded it) and is capped at
    10x ``reserve`` (so a long quiet period cannot bank an unbounded
    storm allowance). Thread-safe; one shared instance per process (see
    :func:`default_budget`) is the normal deployment — handing the same
    object to every budgeted policy is what makes the bound fleet-wide.
    """

    def __init__(self, ratio: Optional[float] = None,
                 reserve: Optional[float] = None):
        g = _flags.get_flags(["retry_budget_ratio",
                              "retry_budget_reserve"])
        self.ratio = float(ratio if ratio is not None
                           else g["retry_budget_ratio"])
        self.reserve = float(reserve if reserve is not None
                             else g["retry_budget_reserve"])
        self.cap = 10.0 * self.reserve
        self._tokens = min(self.reserve, self.cap)
        self._lock = threading.Lock()
        self.deposits = 0
        self.withdrawals = 0
        self.denials = 0
        self._gauge = _obs.gauge(
            "serving_retry_budget_remaining",
            "tokens left in the shared fleet-wide RetryBudget "
            "(successes deposit FLAGS_retry_budget_ratio, every retry "
            "at a budgeted site withdraws 1; empty bucket = retries "
            "shed as backpressure)")
        self._gauge.set(self._tokens)

    def deposit(self):
        """A success anywhere funds ``ratio`` worth of future retries."""
        with self._lock:
            self._tokens = min(self.cap, self._tokens + self.ratio)
            self.deposits += 1
            self._gauge.set(self._tokens)

    def try_withdraw(self, n: float = 1.0) -> bool:
        """Spend ``n`` tokens for a retry; False means the fleet has
        exhausted its retry allowance and the caller must give up."""
        with self._lock:
            if self._tokens >= n:
                self._tokens -= n
                self.withdrawals += 1
                self._gauge.set(self._tokens)
                return True
            self.denials += 1
            return False

    def remaining(self) -> float:
        with self._lock:
            return self._tokens

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {"tokens": self._tokens, "ratio": self.ratio,
                    "reserve": self.reserve, "cap": self.cap,
                    "deposits": self.deposits,
                    "withdrawals": self.withdrawals,
                    "denials": self.denials}


# Sites whose retries ride the shared budget: the serving hot paths
# where a correlated fault (replica down, handoff stall) hits every
# in-flight request at once. Checkpoint/PS-style sites keep per-call
# semantics — their failures are rarely correlated across requests.
BUDGETED_SITES: Tuple[str, ...] = ("serving.route", "serving.handoff",
                                   "serving.replica")

_default_budget: Optional[RetryBudget] = None
_default_budget_lock = threading.Lock()


def default_budget() -> RetryBudget:
    """The process-wide shared budget budgeted sites attach to."""
    global _default_budget
    with _default_budget_lock:
        if _default_budget is None:
            _default_budget = RetryBudget()
        return _default_budget


def reset_default_budget():
    """Drop the shared budget so the next use rebuilds from flags
    (tests; mirrors monitor/observability reset idioms)."""
    global _default_budget
    with _default_budget_lock:
        _default_budget = None


class RetryPolicy:
    """``policy.call(fn, *args)`` — run fn, retrying transient failures.

    - ``retry_on``: exception classes considered transient
    - ``giveup_on``: subclasses of those that are NOT (checked first)
    - backoff: ``base_delay * 2**attempt`` capped at ``max_delay``,
      each scaled by ``1 + jitter*u`` with u drawn from a PRNG seeded
      by (site, FLAGS_fault_seed) — deterministic under test specs
    - ``deadline``: seconds of wall clock after which the policy stops
      retrying even with attempts left
    """

    def __init__(self, max_attempts: Optional[int] = None,
                 base_delay: Optional[float] = None,
                 max_delay: Optional[float] = None,
                 deadline: Optional[float] = None,
                 jitter: float = 0.25,
                 retry_on: Tuple[Type[BaseException], ...] =
                 (OSError, EOFError, ConnectionError),
                 giveup_on: Tuple[Type[BaseException], ...] =
                 _NON_TRANSIENT,
                 site: str = "",
                 sleep: Callable[[float], None] = time.sleep,
                 clock: Callable[[], float] = time.monotonic,
                 budget: Optional[RetryBudget] = None):
        g = _flags.get_flags(["retry_max_attempts", "retry_base_delay",
                              "retry_max_delay", "retry_deadline",
                              "fault_seed"])
        self.max_attempts = int(max_attempts if max_attempts is not None
                                else g["retry_max_attempts"])
        self.base_delay = float(base_delay if base_delay is not None
                                else g["retry_base_delay"])
        self.max_delay = float(max_delay if max_delay is not None
                               else g["retry_max_delay"])
        self.deadline = float(deadline if deadline is not None
                              else g["retry_deadline"])
        self.jitter = float(jitter)
        self.retry_on = retry_on
        self.giveup_on = giveup_on
        self.site = site
        self._sleep = sleep
        self._clock = clock
        self._rng = random.Random(f"{g['fault_seed']}:{site}")
        self.budget = budget

    @classmethod
    def from_flags(cls, site: str, **overrides) -> "RetryPolicy":
        """Flag-configured policy for a named site (the common path).
        ``BUDGETED_SITES`` automatically attach the shared fleet-wide
        :class:`RetryBudget` unless the caller passed ``budget=``."""
        if site in BUDGETED_SITES and "budget" not in overrides:
            overrides["budget"] = default_budget()
        return cls(site=site, **overrides)

    def backoff(self, attempt: int) -> float:
        """Delay before retry number ``attempt`` (0-based)."""
        d = min(self.max_delay, self.base_delay * (2.0 ** attempt))
        return d * (1.0 + self.jitter * self._rng.random())

    def call(self, fn: Callable, *args, **kwargs):
        start = self._clock()
        last: Optional[BaseException] = None
        budget_out = False
        for attempt in range(self.max_attempts):
            try:
                result = fn(*args, **kwargs)
            except self.giveup_on:
                raise
            except self.retry_on as e:
                last = e
                if attempt + 1 >= self.max_attempts:
                    break
                delay = self.backoff(attempt)
                if self._clock() + delay - start > self.deadline:
                    break
                # fleet-wide bound checked *before* the retry goes out:
                # an empty bucket means correlated failure is already
                # storming — shed this call as backpressure instead
                if self.budget is not None and \
                        not self.budget.try_withdraw():
                    budget_out = True
                    break
                _monitor.stat_add(
                    f"STAT_retry_{self.site or 'anonymous'}")
                self._sleep(delay)
            else:
                if self.budget is not None:
                    self.budget.deposit()
                return result
        if budget_out:
            raise RetryError(
                f"{self.site or 'operation'} failed and the shared "
                f"RetryBudget is exhausted — shedding instead of "
                f"retrying (last: {last!r})") from last
        raise RetryError(
            f"{self.site or 'operation'} failed after "
            f"{self.max_attempts} attempts / "
            f"{self._clock() - start:.1f}s (last: {last!r})") from last

    def wrap(self, fn: Callable) -> Callable:
        """Decorator form: ``guarded = policy.wrap(fn)``."""
        def wrapped(*args, **kwargs):
            return self.call(fn, *args, **kwargs)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped
