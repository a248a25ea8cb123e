"""The collective ops — the counterpart of
``paddle_tpu/ops/collective_ops.py`` — at one rank (ROADMAP A5a).

The reference binds each op's ``ring_id`` to a mesh axis (the
LoweringContext's ``axis_env``, else the distributed env's ring map)
and lowers it to a ``jax.lax`` collective over that axis; with no axis
bound it returns its input, the single-trainer behaviour. The port runs
one rank, so every lowering takes that branch: the reduction,
broadcast, gather, scatter and split ops return ``X``, ``barrier`` its
input (or a ``[1]`` zero), ``c_embedding`` is a take of the ids shifted
by ``start_index`` and ``sync_batch_norm`` normalizes with the local
batch statistics. An axis bound over more than one rank (the current
mesh gives it a size above 1) raises NotImplementedError naming ROADMAP
A5b, the multi-card plane.

The registry fields are the reference's (every collective
``side_effect=True``, so dead-code analysis never drops communication;
``c_embedding``'s ``Ids`` and ``sync_batch_norm``'s statistics take no
gradient), and so are the static infer rules (``:239-312``), which key
off the ``nranks`` attr (absent or 1 is the one-rank identity), so the
verifier and the abstract interpreter read a program holding them as
the reference does.
"""

from __future__ import annotations

import torch

from .registry import LoweringContext, register


def _axis(ctx: LoweringContext, attrs):
    """The mesh axis the op's ring is bound to, None at one rank (no
    axis, or an axis of size 1); an axis over more ranks raises."""
    from ..distributed import env as dist_env
    ring = attrs.get("ring_id", 0)
    ax = ctx.axis_name(ring)
    if ax is None:
        ax = dist_env.axis_for_ring(ring)
    if ax is None:
        return None
    mesh = ctx.mesh or dist_env.current_mesh()
    size = int(dict(getattr(mesh, "shape", {}) or {}).get(ax, 1))
    if size > 1:
        raise NotImplementedError(
            f"a collective over mesh axis {ax!r} of {size} ranks: the "
            "port runs one rank; collectives across cards wait for "
            "ROADMAP A5b (the multi-card plane)")
    return None


def _identity(ctx, ins, attrs):
    _axis(ctx, attrs)
    return {"Out": [ins["X"][0]]}


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


_GATHER = _scaled_dim_infer(0, "mul")
_SCATTER = _scaled_dim_infer(0, "div")
# the reference's registration order
for _name, _infer in (("c_allreduce_sum", _identity_infer),
                      ("c_allreduce_max", _identity_infer),
                      ("c_allreduce_min", _identity_infer),
                      ("c_allreduce_prod", _identity_infer),
                      ("c_allreduce_avg", _identity_infer),
                      ("allreduce", _identity_infer),
                      ("c_broadcast", _identity_infer),
                      ("c_allgather", _GATHER),
                      ("c_reducescatter", _SCATTER),
                      ("c_reduce_sum", _identity_infer),
                      ("c_scatter", _SCATTER),
                      ("c_concat", _GATHER),
                      ("c_split", _scaled_dim_infer(-1, "div")),
                      ("c_identity", _identity_infer)):
    register(_name, side_effect=True, infer=_infer)(_identity)
for _name in ("c_sync_calc_stream", "c_sync_comm_stream"):
    register(_name, not_differentiable=True, side_effect=True,
             infer=_identity_infer)(_identity)


@register("barrier", not_differentiable=True, side_effect=True,
          infer=_barrier_infer)
def _barrier(ctx, ins, attrs):
    _axis(ctx, attrs)
    if ins.get("X"):
        return {"Out": [ins["X"][0]]}
    return {"Out": [torch.zeros((1,), dtype=torch.float32,
                                device=ctx.device)]}


@register("c_embedding", no_grad_slots=("Ids",), side_effect=True,
          infer=_c_embedding_infer)
def _c_embedding(ctx, ins, attrs):
    """The vocabulary-sharded lookup at one rank: ``jnp.take(W, Ids -
    start_index, axis=0)``, whose default mode wraps an index down to
    ``-len(W)`` and fills rows out of range with NaN."""
    w, ids = ins["W"][0], ins["Ids"][0]
    _axis(ctx, attrs)
    n = w.shape[0]
    local = ids.long() - int(attrs.get("start_index", 0))
    local = torch.where(local < 0, local + n, local)
    valid = (local >= 0) & (local < n)
    rows = w[local.clamp(0, n - 1)]
    return {"Out": [torch.where(valid[..., None], rows,
                                torch.full_like(rows, float("nan")))]}


register("partial_allgather", side_effect=True, infer=_GATHER)(_identity)


@register("sync_batch_norm", no_grad_slots=("Mean", "Variance"),
          nondiff_outputs=("MeanOut", "VarianceOut", "SavedMean",
                           "SavedVariance", "ReserveSpace"),
          infer=_sync_batch_norm_infer)
def _sync_batch_norm(ctx, ins, attrs):
    """Batch norm over the local batch (the reference outside a mesh):
    the statistics are sums over the non-channel axes divided by their
    count, ``E[x^2] - E[x]^2`` for the variance, in the reference's
    order."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean, var = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    _axis(ctx, attrs)
    caxis = 1 if attrs.get("data_format", "NCHW") == "NCHW" else x.dim() - 1
    raxes = tuple(i for i in range(x.dim()) if i != caxis)
    bshape = [1] * x.dim()
    bshape[caxis] = x.shape[caxis]
    if attrs.get("is_test", False) or attrs.get("use_global_stats", False):
        m, v = mean, var
        mean_out, var_out = mean, var
    else:
        cnt = 1.0
        for i in raxes:
            cnt *= x.shape[i]
        m = torch.sum(x, dim=raxes) / cnt
        v = torch.sum(torch.square(x), dim=raxes) / cnt - m * m
        mean_out = momentum * mean + (1 - momentum) * m
        var_out = momentum * var + (1 - momentum) * v
    inv = torch.rsqrt(v + eps)
    y = (x - m.reshape(bshape)) * inv.reshape(bshape) * \
        scale.reshape(bshape) + bias.reshape(bshape)
    return {"Y": [y], "MeanOut": [mean_out], "VarianceOut": [var_out],
            "SavedMean": [m], "SavedVariance": [v]}
