"""Parameter-server ops — the counterpart of ``paddle_tpu/ops/ps_ops.py``:
host sparse tables <-> dense compute on the card.

Analogs of operators/distributed_ops/ (distributed_lookup_table_op,
send_op/recv_op) and the prefetch path
(operators/distributed/parameter_prefetch.cc). The reference crosses the
host/device boundary with an ordered ``io_callback`` inside the compiled
step. Here each op is a host op (``host_op=True``): on the card the
executor splits a captured key at each one (``plan_pieces``), replays
the graph pieces between them and runs the op itself on the host, in
program order, every step:

- the pull (``distributed_lookup_table``) reads ``Ids`` from the host
  side of the feed (the run's numpy batch: no copy back from the card)
  when ``Ids`` is fed, gathers the rows from the table (init-on-miss)
  and hands them to the next graph piece's held input;
- the push (``distributed_lookup_table_grad``) reads ``Out@GRAD`` from
  the card (one copy to the host per table per step, counted in
  ``Executor.host_syncs``) and hands ``(ids, grads)`` to the
  communicator (``distributed/ps/runtime.py``), or straight to the
  table without one. In sync mode the push has landed when the op
  returns, so step k's push is on the table before step k+1's pull, the
  reference's ``ordered=True`` guarantee.

The tables are :data:`~..distributed.ps.sparse_table.REGISTRY`'s: in
the trainer's process, or on PS servers once ``fleet.init_worker``
connected the registry to them. ``send`` / ``recv`` store and load a
dense value in the registry as the reference's single-process backend
does. The static infer rules read every shape from attrs, as the
reference's do (``:143-181``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import control_flow_ops as _cf
from .registry import register, register_infer


def _table_name(attrs):
    tn = attrs.get("table_names")
    if isinstance(tn, (list, tuple)):
        return tn[0]
    return attrs.get("table_name", tn)


def _lookup_table_grad_maker(op, out_grad_names, wanted_input_grads):
    """Always emit the push op when a grad flows into Out — the 'parameter'
    lives host-side, so the default maker (which keys on wanted *input*
    grads) would silently drop the update. Analog of the reference's
    send_op insertion by the distribute transpiler."""
    gs = out_grad_names.get("Out", [])
    g = next((x for x in gs if x is not None), None)
    if g is None:
        return []
    from ..framework import unique_name
    token = unique_name.generate(_table_name(op.attrs) + "@PUSH")
    op.block.create_var(token, stop_gradient=True)
    g_in = {"Ids": list(op.inputs["Ids"]), "Out@GRAD": [g]}
    return [("distributed_lookup_table_grad", g_in,
             {"W@GRAD": [token]}, dict(op.attrs))]


def _device(ctx, t):
    if isinstance(t, torch.Tensor):
        return t.device
    return ctx.device or torch.device("cpu")


def _to_host(name: str, t) -> np.ndarray:
    """``t`` as a numpy array; a card tensor is copied back (a host read,
    which waits for the card), never under a capture."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if t.is_cuda:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"{name} runs on the host and cannot be captured; the "
                f"executor splits a key at a top-level one")
        _cf.note_host_read()
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def _host_ids(ctx, ins, name) -> np.ndarray:
    """The op's ``Ids`` on the host: the run's host feed when ``Ids`` is
    fed (the executor hands it over as ``ctx.host_feed``), else the
    value itself."""
    feed = getattr(ctx, "host_feed", None)
    op = getattr(ctx, "op", None)
    if feed and op is not None:
        fed = feed.get(op.inputs["Ids"][0])
        if fed is not None:
            return _to_host(name, fed)
    return _to_host(name, ins["Ids"][0])


@register("distributed_lookup_table", no_grad_slots=("Ids",),
          grad_drops_inputs=("W",), virtual_param=True,
          custom_grad_maker=_lookup_table_grad_maker, side_effect=True,
          host_op=True)
def _distributed_lookup_table(ctx, ins, attrs):
    """Pull rows from the host sparse table (init-on-miss)."""
    from ..distributed.ps.sparse_table import REGISTRY
    ids = _host_ids(ctx, ins, "distributed_lookup_table")
    dim = int(attrs["value_dim"])
    table = REGISTRY.get_or_create(_table_name(attrs), dim,
                                   optimizer=attrs.get("sparse_optimizer",
                                                       "sgd"),
                                   lr=attrs.get("sparse_lr", 0.01))
    rows = np.asarray(table.pull(ids), np.float32)
    rows = rows.reshape(tuple(ids.shape) + (dim,))
    out = torch.from_numpy(np.ascontiguousarray(rows))
    return {"Out": [out.to(_device(ctx, ins["Ids"][0]))]}


@register("distributed_lookup_table_grad", side_effect=True, host_op=True)
def _distributed_lookup_table_grad(ctx, ins, attrs):
    """Push: route the gradient to the communicator (send_op analog)."""
    from ..distributed.ps import runtime as ps_runtime
    from ..distributed.ps.sparse_table import REGISTRY
    name = "distributed_lookup_table_grad"
    ids = _host_ids(ctx, ins, name)
    g = _to_host(name, ins["Out@GRAD"][0])
    table_name = _table_name(attrs)
    comm = ps_runtime.get_communicator()
    if comm is not None:
        comm.push_sparse(table_name, ids, g)
    else:
        table = REGISTRY.get(table_name)
        if table is not None:
            table.push(ids, g)
    # the op has no dense W grad: a scalar completion token
    return {"W@GRAD": [torch.zeros((), dtype=torch.float32,
                                   device=_device(ctx, ins["Ids"][0]))]}


@register("send", not_differentiable=True, side_effect=True, host_op=True)
def _send(ctx, ins, attrs):
    """Dense var push to the PS tier (send_op.cc analog): in the
    single-process backend, a store into the registry."""
    from ..distributed.ps.sparse_table import REGISTRY
    x_np = _to_host("send", ins["X"][0])
    name = attrs.get("send_varnames", ["var"])[0]
    t = REGISTRY.get_or_create(f"__dense__{name}",
                               int(np.prod(x_np.shape)))
    t._dense = np.asarray(x_np)
    return {"Out": [torch.zeros((), dtype=torch.float32,
                                device=_device(ctx, ins["X"][0]))]}


@register("recv", not_differentiable=True, side_effect=True, host_op=True)
def _recv(ctx, ins, attrs):
    from ..distributed.ps.sparse_table import REGISTRY
    name = attrs.get("recv_varnames", ["var"])[0]
    shape = tuple(attrs["shape"])
    t = REGISTRY.get(f"__dense__{name}")
    if t is None or not hasattr(t, "_dense"):
        val = np.zeros(shape, np.float32)
    else:
        val = t._dense.reshape(shape).astype(np.float32)
    return {"Out": [torch.from_numpy(np.ascontiguousarray(val)).to(
        ctx.device or torch.device("cpu"))]}


# ---------------------------------------------------------------------------
# static infer rules (the abstract interpreter): the lowerings touch host
# tables, so they are side_effect=True and never run on meta tensors; the
# shapes are fully attr-determined instead
# ---------------------------------------------------------------------------


@register_infer("distributed_lookup_table")
def _lookup_infer(ictx, ins, attrs):
    from ..analysis.abstract_interp import AbstractVar
    ids = ins["Ids"][0]
    dim = int(attrs["value_dim"])
    if not ids.known:
        return {"Out": [AbstractVar()]}
    return {"Out": [AbstractVar(ids.shape + (dim,), "float32")]}


@register_infer("distributed_lookup_table_grad")
def _lookup_grad_infer(ictx, ins, attrs):
    from ..analysis.abstract_interp import AbstractVar
    # the push emits a scalar completion token, not a dense grad
    return {"W@GRAD": [AbstractVar((), "float32")]}


@register_infer("send")
def _send_infer(ictx, ins, attrs):
    from ..analysis.abstract_interp import AbstractVar
    return {"Out": [AbstractVar((), "float32")]}


@register_infer("recv")
def _recv_infer(ictx, ins, attrs):
    from ..analysis.abstract_interp import AbstractVar
    return {"Out": [AbstractVar(tuple(int(d) for d in attrs["shape"]),
                                "float32")]}
