"""``subgraph_delegate`` — the counterpart of
``paddle_tpu/ops/delegate_ops.py``: runs a cluster that
``framework/subgraph.py``'s pass delegated.

Engine-op analog (operators/tensorrt_engine_op.h: the reference's engine
op deserializes its subgraph and hands execution to TensorRT). The
default ``inline`` engine replays the sub-ops through the lowering
registry inside the enclosing run: eagerly, or inside the executor's
CUDA-graph capture on the card, so a delegated cluster launches the same
kernels as the ops it replaced. An engine registered under another name
(``framework.subgraph.register_delegate_engine``) takes the cluster's
inputs and returns its outputs instead; under a captured key it runs at
the capture only, and replays run what it launched there.
"""

from __future__ import annotations

import json

from .registry import LoweringContext, execute, register


def _run_inline(sub_ops, env, ctx):
    for op in sub_ops:
        ins = {slot: [env[n] for n in names]
               for slot, names in op["inputs"].items()
               if all(n in env for n in names)}
        outs = execute(ctx, op["type"], ins, op["attrs"])
        for slot, names in op["outputs"].items():
            vals = outs.get(slot, [])
            for n, v in zip(names, vals):
                env[n] = v
    return env


@register("subgraph_delegate", not_differentiable=True)
def _subgraph_delegate(ctx: LoweringContext, ins, attrs):
    sub_ops = json.loads(attrs["sub_ops"])
    in_names = list(attrs["input_names"])
    out_names = list(attrs["output_names"])
    env = dict(zip(in_names, ins["X"]))
    engine = attrs.get("engine", "inline")
    if engine != "inline":
        from ..framework.subgraph import get_delegate_engine
        runner = get_delegate_engine(engine)
        if runner is None:
            raise RuntimeError(
                f"subgraph_delegate: engine {engine!r} is not "
                "registered (framework.subgraph.register_delegate_engine)")
        outs = runner(sub_ops, dict(env), ctx)
        return {"Out": [outs[n] for n in out_names]}
    env = _run_inline(sub_ops, env, ctx)
    return {"Out": [env[n] for n in out_names]}
