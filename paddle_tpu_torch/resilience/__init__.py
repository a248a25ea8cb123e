"""Resilience plane of the port, the counterpart of
``paddle_tpu/resilience``:

- :mod:`injector` — named ``fault_point(site)`` hooks driven by a
  seeded, deterministic spec (``FLAGS_fault_spec`` /
  ``PADDLE_TPU_FAULT_SPEC``), a no-op when unset;
- :mod:`retry` — ``RetryPolicy``: exponential backoff + deterministic
  jitter + deadline, with the fleet-wide ``RetryBudget``.

Every injected fault and every retry increments a
``paddle_tpu_torch.monitor`` counter (``STAT_fault_*`` /
``STAT_retry_*``). The training supervisor ``guardian.py``
(``TrainGuardian``) is not ported yet.
"""

from .injector import (FAULT_SITE_DOCS, FAULT_SITES, FaultInjector,
                       InjectedDrop, InjectedFault, InjectedIOError,
                       InjectedPreemption, fault_point, fault_scope,
                       injector_active, parse_spec, set_time_source)
from .retry import (BUDGETED_SITES, RetryBudget, RetryError, RetryPolicy,
                    default_budget, reset_default_budget)

__all__ = [
    "BUDGETED_SITES", "FAULT_SITE_DOCS", "FAULT_SITES", "FaultInjector",
    "InjectedDrop", "InjectedFault", "InjectedIOError", "InjectedPreemption",
    "RetryBudget", "RetryError", "RetryPolicy", "default_budget",
    "fault_point", "fault_scope", "injector_active", "parse_spec",
    "reset_default_budget", "set_time_source",
]
