"""The parameter-server ops — the counterpart of
``paddle_tpu/ops/ps_ops.py`` — declared, not lowered: the in-graph pull
and push wait for the PS runtime (ROADMAP A7.4) and raise naming it when
run (the port's PS tier is host-paced: ``distributed/ps/host_paced.py``).

The declarations keep the reference's registry fields (every op
``side_effect=True``: its lowering touches host tables, so dead-code
analysis keeps it and the abstract interpreter never runs it; the pull's
``Ids`` take no gradient and its grad op is the push) and its static
infer rules (``:143-181``), which read every shape from attrs.
"""

from __future__ import annotations

from .registry import declare_waiting


def _av(shape=None, dtype=None):
    from ..analysis.abstract_interp import AbstractVar
    return AbstractVar(shape, dtype)


def _table_name(attrs):
    tn = attrs.get("table_names")
    if isinstance(tn, (list, tuple)):
        return tn[0]
    return attrs.get("table_name", tn)


def _lookup_table_grad_maker(op, out_grad_names, wanted_input_grads):
    """The reference's maker (``ps_ops.py:34-50``): the push op whenever
    a gradient flows into Out (the parameter lives on the host)."""
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


def _lookup_infer(ictx, ins, attrs):
    ids = ins["Ids"][0]
    dim = int(attrs["value_dim"])
    if not ids.known:
        return {"Out": [_av()]}
    return {"Out": [_av(ids.shape + (dim,), "float32")]}


def _lookup_grad_infer(ictx, ins, attrs):
    # the push emits a scalar completion token, not a dense grad
    return {"W@GRAD": [_av((), "float32")]}


def _send_infer(ictx, ins, attrs):
    return {"Out": [_av((), "float32")]}


def _recv_infer(ictx, ins, attrs):
    return {"Out": [_av(tuple(int(d) for d in attrs["shape"]), "float32")]}


declare_waiting("distributed_lookup_table", no_grad_slots=("Ids",),
                grad_drops_inputs=("W",), virtual_param=True,
                custom_grad_maker=_lookup_table_grad_maker,
                side_effect=True, infer=_lookup_infer)
declare_waiting("distributed_lookup_table_grad", side_effect=True,
                infer=_lookup_grad_infer)
declare_waiting("send", not_differentiable=True, side_effect=True,
                infer=_send_infer)
declare_waiting("recv", not_differentiable=True, side_effect=True,
                infer=_recv_infer)
