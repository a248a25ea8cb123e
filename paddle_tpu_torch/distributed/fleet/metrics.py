"""Fleet distributed metrics — cross-worker metric reduction; the
counterpart of ``paddle_tpu/distributed/fleet/metrics.py``.

Analog of python/paddle/distributed/fleet/metrics/metric.py (sum/max/
min/auc reduced over trainers). The port runs one process, so every
reduction is over that process's own values; the gather across
processes waits for ROADMAP A5.
"""

from __future__ import annotations

import numpy as np


def _gather(value: np.ndarray) -> np.ndarray:
    """[num_processes, ...] stack of every process's value: one here."""
    return np.asarray(value)[None]


def sum(value):  # noqa: A001 - reference API name
    return _gather(value).sum(axis=0)


def max(value):  # noqa: A001
    return _gather(value).max(axis=0)


def min(value):  # noqa: A001
    return _gather(value).min(axis=0)


def acc(correct, total):
    c = _gather(np.asarray(correct, np.float64)).sum()
    t = _gather(np.asarray(total, np.float64)).sum()
    return float(c / t) if t else 0.0


def mean(value, count):
    v = _gather(np.asarray(value, np.float64) *
                np.asarray(count, np.float64)).sum()
    c = _gather(np.asarray(count, np.float64)).sum()
    return float(v / c) if c else 0.0


def _auc_from_buckets(pos, neg) -> float:
    """ROC-AUC from threshold-bucket counts by trapezoid integration
    over thresholds descending (the reference's
    ``paddle_tpu/metric.py:157``)."""
    pos = np.asarray(pos)
    neg = np.asarray(neg)
    tot_pos = pos.sum()
    tot_neg = neg.sum()
    if not tot_pos or not tot_neg:
        return 0.0
    tpr = np.cumsum(pos[::-1]) / tot_pos
    fpr = np.cumsum(neg[::-1]) / tot_neg
    return float(np.trapezoid(tpr, fpr))


def auc(stat_pos, stat_neg):
    """Merge per-worker AUC bucket stats (fleet metrics auc): inputs are
    the threshold-bucket positive/negative counts, summed across workers
    before the trapezoid."""
    pos = _gather(np.asarray(stat_pos)).sum(axis=0)
    neg = _gather(np.asarray(stat_neg)).sum(axis=0)
    return _auc_from_buckets(pos, neg)
