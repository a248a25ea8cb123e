"""The user-facing collectives — the counterpart of
``paddle_tpu/distributed/collective.py``: ``all_reduce``, ``broadcast``,
``all_gather``, ``reduce``, ``reduce_scatter``, ``scatter``, ``barrier``
and ``split`` over the tape's :func:`~paddle_tpu_torch.dygraph.tape.run_op`
and the collective ops, at one rank (ROADMAP A5a): each op returns its
input there, so the results are the reference's single-trainer ones.
``all_reduce`` keeps the reference's fault site
(``collective.allreduce``) and, while a fault spec is active, its retry
on ``ConnectionError``.
"""

from __future__ import annotations

from typing import List

from ..dygraph.tape import run_op
from ..dygraph.tensor import Tensor
from ..resilience.injector import fault_point, injector_active
from ..resilience.retry import RetryPolicy


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


def all_reduce(tensor: Tensor, op: str = ReduceOp.SUM, group: int = 0):
    def _attempt():
        # chaos hook: an injected drop stands in for a transport hiccup;
        # the reduce touches nothing until set_value, so replaying the
        # attempt is safe
        fault_point("collective.allreduce")
        return run_op(f"c_allreduce_{op}", {"X": [tensor]},
                      {"ring_id": group})["Out"][0]
    if injector_active():
        out = RetryPolicy.from_flags(
            site="collective.allreduce",
            retry_on=(ConnectionError,)).call(_attempt)
    else:
        out = _attempt()
    tensor.set_value(out.value)
    return out


def broadcast(tensor: Tensor, src: int = 0, group: int = 0):
    out = run_op("c_broadcast", {"X": [tensor]},
                 {"ring_id": group, "root": src})["Out"][0]
    tensor.set_value(out.value)
    return out


def all_gather(tensor_list: List[Tensor], tensor: Tensor, group: int = 0):
    out = run_op("c_allgather", {"X": [tensor]},
                 {"ring_id": group})["Out"][0]
    # split back into per-rank chunks for API parity
    n = out.shape[0] // tensor.shape[0] if tensor.shape else 1
    if tensor_list is not None and n > 1:
        chunks = run_op("split", {"X": [out]}, {"num": n, "axis": 0})["Out"]
        tensor_list.extend(chunks)
    elif tensor_list is not None:
        tensor_list.append(out)
    return out


def reduce(tensor: Tensor, dst: int = 0, op: str = ReduceOp.SUM,
           group: int = 0):
    out = run_op("c_reduce_sum", {"X": [tensor]},
                 {"ring_id": group, "root_id": dst})["Out"][0]
    tensor.set_value(out.value)
    return out


def reduce_scatter(tensor: Tensor, group: int = 0):
    return run_op("c_reducescatter", {"X": [tensor]},
                  {"ring_id": group})["Out"][0]


def scatter(tensor: Tensor, tensor_list=None, src: int = 0, group: int = 0):
    from . import env as dist_env
    x = tensor if tensor_list is None else run_op(
        "concat", {"X": tensor_list}, {"axis": 0})["Out"][0]
    mesh = dist_env.current_mesh()
    nranks = 1
    ax = dist_env.axis_for_ring(group)
    if mesh is not None and ax in mesh.shape:
        nranks = mesh.shape[ax]
    return run_op("c_scatter", {"X": [x]},
                  {"ring_id": group, "nranks": nranks})["Out"][0]


def barrier(group: int = 0):
    run_op("barrier", {}, {"ring_id": group})


def split(x: Tensor, group: int = 0, nranks: int = 1):
    return run_op("c_split", {"X": [x]},
                  {"ring_id": group, "nranks": nranks})["Out"][0]
