"""The port's learning-rate schedulers (``paddle_tpu_torch.optimizer.lr``)
against the JAX package's (``paddle_tpu.optimizer.lr``): every
scheduler's first 50 values, its ``last_epoch`` and its ``state_dict``,
held EXACTLY (``==`` on Python floats): both are host arithmetic, so
any difference is a fault."""

import math

import numpy as np
import pytest

from paddle_tpu import optimizer as jopt
from paddle_tpu_torch import optimizer as topt

STEPS = 50


def _both(name, *args, **kw):
    return (getattr(jopt.lr, name)(*args, **kw),
            getattr(topt.lr, name)(*args, **kw))


CASES = [
    ("NoamDecay", (512, 10), {}),
    ("NoamDecay", (64, 4), {"learning_rate": 2.0, "last_epoch": 3}),
    ("PiecewiseDecay", ([5, 20, 30], [1.0, 0.5, 0.1, 0.01]), {}),
    ("NaturalExpDecay", (0.5, 0.1), {}),
    ("ExponentialDecay", (0.5, 0.93), {}),
    ("InverseTimeDecay", (0.5, 0.2), {}),
    ("PolynomialDecay", (0.1, 20), {}),
    ("PolynomialDecay", (0.1, 7), {"end_lr": 0.001, "power": 2.0,
                                   "cycle": True}),
    ("CosineAnnealingDecay", (0.1, 30), {}),
    ("CosineAnnealingDecay", (0.1, 12), {"eta_min": 0.01,
                                         "last_epoch": 4}),
    ("LinearWarmup", (0.1, 10, 0.0, 0.1), {}),
    ("StepDecay", (0.5, 7), {}),
    ("StepDecay", (0.5, 3), {"gamma": 0.5}),
    ("MultiStepDecay", (0.5, [3, 10, 40]), {}),
    ("LambdaDecay", (0.5, lambda e: 0.95 ** e + 1.0 / (e + 1)), {}),
]


@pytest.mark.parametrize("name,args,kw", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_scheduler_values_are_the_references(name, args, kw):
    j, t = _both(name, *args, **kw)
    for _ in range(STEPS):
        assert t() == j() and type(t()) is type(j())
        assert t.last_epoch == j.last_epoch
        assert t.state_dict() == j.state_dict()
        j.step()
        t.step()
    j.step(3)
    t.step(3)
    assert (t(), t.last_epoch) == (j(), j.last_epoch)


def test_linear_warmup_wraps_a_scheduler():
    """LinearWarmup over CosineAnnealingDecay (the GPT schedule of the
    card's phase 18): the wrapped scheduler steps from the warmup's end;
    a state_dict round trip resumes the same sequence."""
    j = jopt.lr.LinearWarmup(jopt.lr.CosineAnnealingDecay(3e-4, 40), 8,
                             0.0, 3e-4)
    t = topt.lr.LinearWarmup(topt.lr.CosineAnnealingDecay(3e-4, 40), 8,
                             0.0, 3e-4)
    seen = []
    for _ in range(STEPS):
        assert t() == j()
        seen.append(t())
        j.step()
        t.step()
    assert seen[0] == 0.0 and seen[8] == 3e-4 and seen[-1] < seen[8]
    assert t.lr() == j.lr() and t.lr.last_epoch == j.lr.last_epoch
    resumed = topt.lr.LinearWarmup(topt.lr.CosineAnnealingDecay(3e-4, 40),
                                   8, 0.0, 3e-4)
    resumed.set_state_dict(t.state_dict())
    assert resumed() == t() and resumed.last_epoch == t.last_epoch


def test_reduce_on_plateau_follows_a_metric_sequence():
    """A fixed metric sequence: falls, a plateau longer than the patience
    (reductions, with cooldown), a rise in "max" mode; None steps only
    advance the epoch."""
    rng = np.random.RandomState(0)
    metrics = list(np.linspace(1.0, 0.5, 10)) + [0.5] * 25 + \
        list(0.5 + rng.rand(15) * 1e-3)
    for mode in ("min", "max"):
        j = jopt.lr.ReduceOnPlateau(0.1, mode=mode, factor=0.5, patience=3,
                                    threshold=1e-4, cooldown=2,
                                    min_lr=0.004)
        t = topt.lr.ReduceOnPlateau(0.1, mode=mode, factor=0.5, patience=3,
                                    threshold=1e-4, cooldown=2,
                                    min_lr=0.004)
        lrs = []
        for i, m in enumerate(metrics):
            value = None if i % 11 == 5 else (m if mode == "min" else -m)
            j.step(value)
            t.step(value)
            assert t() == j() and t.last_epoch == j.last_epoch
            assert (t.best, t.num_bad, t.cooldown_counter) == \
                (j.best, j.num_bad, j.cooldown_counter)
            lrs.append(t())
        assert min(lrs) == 0.004 if mode == "min" else lrs[-1] < 0.1


def test_every_scheduler_is_ported():
    names = {n for n, v in vars(jopt.lr).items()
             if isinstance(v, type) and issubclass(v, jopt.lr.LRScheduler)}
    assert len(names) == 13            # the base and its 12 schedulers
    for n in names:
        assert issubclass(getattr(topt.lr, n), topt.lr.LRScheduler), n
    assert {c[0] for c in CASES} | {"ReduceOnPlateau", "LRScheduler"} \
        == names
    assert math.isclose(topt.lr.ExponentialDecay(1.0, 0.5)(), 1.0)
