"""The collective ops — the counterpart of
``paddle_tpu/ops/collective_ops.py`` — declared, not lowered: each waits
for the multi-card plane (ROADMAP A5) and raises naming it when run.

The declarations keep the reference's registry fields (every collective
``side_effect=True``, so dead-code analysis never drops communication;
``c_embedding``'s ``Ids`` and ``sync_batch_norm``'s statistics take no
gradient) and its static infer rules (``:239-312``), which key off the
``nranks`` attr (absent or 1 is the one-rank identity), so the verifier
and the abstract interpreter read a program holding them as the
reference does.
"""

from __future__ import annotations

from .registry import declare_waiting


def _av(shape=None, dtype=None):
    from ..analysis.abstract_interp import AbstractVar
    return AbstractVar(shape, dtype)


def _identity_infer(ictx, ins, attrs):
    return {"Out": list(ins.get("X", []))}


def _nranks(attrs) -> int:
    return int(attrs.get("nranks", 1) or 1)


def _scaled_dim_infer(dim, mode):
    """Out = X with ``dim`` multiplied (gather) or divided (scatter) by
    nranks; divisibility is a static contract."""
    def rule(ictx, ins, attrs):
        x = ins["X"][0]
        n = _nranks(attrs)
        if n <= 1 or not x.known:
            return {"Out": [x]}
        shape = list(x.shape)
        d = x.shape[dim]
        if mode == "mul":
            shape[dim] = d * n if d >= 0 else -1
        else:
            if d >= 0 and d % n:
                ictx.fail(
                    f"dim {dim} of X ({d}) is not divisible by "
                    f"nranks={n}")
            shape[dim] = d // n if d >= 0 else -1
        return {"Out": [_av(tuple(shape), x.dtype)]}
    return rule


def _barrier_infer(ictx, ins, attrs):
    if ins.get("X"):
        return {"Out": [ins["X"][0]]}
    return {"Out": [_av((1,), "float32")]}


def _c_embedding_infer(ictx, ins, attrs):
    w, ids = ins["W"][0], ins["Ids"][0]
    if not (w.known and ids.known):
        return {"Out": [_av()]}
    if len(w.shape) != 2:
        ictx.fail(f"W must be rank-2 (vocab_shard, dim), got {w}")
    return {"Out": [_av(ids.shape + (w.shape[1],), w.dtype)]}


def _sync_batch_norm_infer(ictx, ins, attrs):
    """The reference eval_shapes its lowering: ``Y`` is ``X``; the
    running statistics keep theirs; the saved ones are the batch's
    ``[C]`` in X's dtype (the running ones under ``is_test`` or
    ``use_global_stats``)."""
    x, mean, var = ins["X"][0], ins["Mean"][0], ins["Variance"][0]
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        saved = [mean, var]
    elif x.known:
        c = x.shape[1 if attrs.get("data_format", "NCHW") == "NCHW" else -1]
        saved = [_av((c,), x.dtype)] * 2
    else:
        saved = [_av()] * 2
    return {"Y": [x], "MeanOut": [mean], "VarianceOut": [var],
            "SavedMean": [saved[0]], "SavedVariance": [saved[1]]}


for _name in ("c_allreduce_sum", "c_allreduce_max", "c_allreduce_min",
              "c_allreduce_prod", "c_allreduce_avg", "allreduce",
              "c_broadcast", "c_reduce_sum", "c_identity"):
    declare_waiting(_name, side_effect=True, infer=_identity_infer)
for _name in ("c_sync_calc_stream", "c_sync_comm_stream"):
    declare_waiting(_name, not_differentiable=True, side_effect=True,
                    infer=_identity_infer)
for _name, _dim, _mode in (("c_allgather", 0, "mul"),
                           ("c_concat", 0, "mul"),
                           ("partial_allgather", 0, "mul"),
                           ("c_reducescatter", 0, "div"),
                           ("c_scatter", 0, "div"),
                           ("c_split", -1, "div")):
    declare_waiting(_name, side_effect=True,
                    infer=_scaled_dim_infer(_dim, _mode))
declare_waiting("barrier", not_differentiable=True, side_effect=True,
                infer=_barrier_infer)
declare_waiting("c_embedding", no_grad_slots=("Ids",), side_effect=True,
                infer=_c_embedding_infer)
declare_waiting("sync_batch_norm", no_grad_slots=("Mean", "Variance"),
                nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean",
                                 "SavedVariance", "ReserveSpace"),
                infer=_sync_batch_norm_infer)
