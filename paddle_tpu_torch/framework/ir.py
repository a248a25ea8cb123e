"""ir::Graph + Pass framework — the counterpart of
``paddle_tpu/framework/ir.py``: ``IrGraph`` (a dataflow view over one
block of a Program), ``Pass``, ``register_pass`` / ``new_pass`` /
``apply_pass``, ``PassManager`` and the three concrete passes
(``fuse_elewise_add_act_pass``, ``delete_dropout_op_pass``,
``fuse_bn_act_pass``), whose fused ops
(``fused_elemwise_activation``, ``fused_scale_bias_relu``) are in
:mod:`~paddle_tpu_torch.ops.fused_ops`.

A pass mutates an ``IrGraph`` and the graph converts back to a runnable
Program; passes never see torch. Under ``FLAGS_check_ir_passes`` the
verifier (``framework/analysis.py``) runs before the first pass and after
every pass, and a failure names the pass that broke the program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .program import Operator, Program


class OpNode:
    """Graph node wrapping one Operator (ir::Node NodeType::kOperation)."""

    def __init__(self, op: Operator, idx: int):
        self.op = op
        self.idx = idx  # position in the block's op list

    @property
    def type(self) -> str:
        return self.op.type

    def input_names(self) -> List[str]:
        return self.op.input_names()

    def output_names(self) -> List[str]:
        return self.op.output_names()

    def __repr__(self):
        return f"OpNode({self.op.type}@{self.idx})"


class IrGraph:
    """Dataflow view over one block of a Program (ir::Graph analog).

    Holds a private clone — passes are functional at the Program level:
    ``IrGraph(prog).apply(...).to_program()`` never mutates ``prog``.
    Sub-blocks of control-flow ops ride along opaquely.
    """

    def __init__(self, program: Program, block_idx: int = 0):
        self._program = program.clone()
        self._block_idx = block_idx
        self._rebuild()

    # -- structure ---------------------------------------------------------
    @property
    def block(self):
        return self._program.blocks[self._block_idx]

    def _rebuild(self):
        self._op_nodes = [OpNode(op, i)
                          for i, op in enumerate(self.block.ops)]
        self._producer: Dict[str, OpNode] = {}
        self._consumers: Dict[str, List[OpNode]] = {}
        for node in self._op_nodes:
            for n in node.output_names():
                self._producer[n] = node  # last writer wins (SSA-ish)
            for n in node.input_names():
                self._consumers.setdefault(n, []).append(node)

    def all_op_nodes(self) -> List[OpNode]:
        return list(self._op_nodes)

    def var_producer(self, name: str) -> Optional[OpNode]:
        return self._producer.get(name)

    def var_consumers(self, name: str) -> List[OpNode]:
        return list(self._consumers.get(name, []))

    def is_persistable(self, name: str) -> bool:
        try:
            return bool(self.block.var(name).persistable)
        except KeyError:
            return False

    # -- mutation ----------------------------------------------------------
    def replace_ops(self, old_nodes: Sequence[OpNode],
                    new_op: Optional[Operator],
                    drop_vars: Sequence[str] = ()):
        """Remove ``old_nodes``; if ``new_op`` is given, insert it at the
        first removed position. ``drop_vars`` (now-dead intermediates)
        leave the block's var table."""
        idxs = sorted(n.idx for n in old_nodes)
        idx_set = set(idxs)
        ops = [op for i, op in enumerate(self.block.ops)
               if i not in idx_set]
        if new_op is not None:
            ops.insert(idxs[0], new_op)
        self.block.ops = ops
        for name in drop_vars:
            self.block.vars.pop(name, None)
        self._rebuild()

    def remove_op_rewire(self, node: OpNode, alias: Dict[str, str]):
        """Delete an op and redirect every downstream read of its outputs
        through ``alias`` (out name -> replacement name) — the delete-op
        pass primitive (e.g. delete_dropout_op_pass)."""
        for consumer in self._op_nodes:
            if consumer.idx <= node.idx:
                continue
            for slot, names in consumer.op.inputs.items():
                consumer.op.inputs[slot] = [alias.get(n, n) for n in names]
        self.replace_ops([node], None, drop_vars=node.output_names())

    def new_op(self, type: str, inputs: dict, outputs: dict,  # noqa: A002
               attrs: dict) -> Operator:
        return Operator(self.block, type, inputs, outputs, attrs)

    # -- pattern matching (GraphPatternDetector lite) ----------------------
    def find_chains(self, op_types: Sequence[str],
                    out_slot: str = "Out") -> List[Tuple[OpNode, ...]]:
        """Maximal-munch linear chains op_types[0] -> ... -> op_types[-1]
        where each link var has exactly ONE consumer, is not persistable,
        and flows through ``out_slot``. The single-consumer constraint is
        what makes the fusion sound: nobody else reads the intermediate."""
        chains = []
        consumed = set()
        for node in self._op_nodes:
            if node.type != op_types[0] or id(node.op) in consumed:
                continue
            chain = [node]
            ok = True
            for next_type in op_types[1:]:
                outs = chain[-1].op.output(out_slot)
                if len(outs) != 1 or self.is_persistable(outs[0]):
                    ok = False
                    break
                users = self.var_consumers(outs[0])
                if len(users) != 1 or users[0].type != next_type:
                    ok = False
                    break
                chain.append(users[0])
            if ok:
                chains.append(tuple(chain))
                consumed.update(id(n.op) for n in chain)
        return chains

    def to_program(self) -> Program:
        """The rewritten Program. Returns the graph's private clone
        directly (the entry clone already isolates the caller's
        program); don't mutate the graph after extracting it."""
        return self._program


# ---------------------------------------------------------------------------
# Pass base + registry (pass.h REGISTER_PASS analog)
# ---------------------------------------------------------------------------


class Pass:
    """Base pass: subclass and implement ``apply_impl(graph)``; mutate the
    graph in place. Configure via attrs (Pass::Set analog)."""

    name = "pass"

    def __init__(self, **attrs):
        self._attrs = dict(attrs)

    def set_attr(self, key: str, value):
        self._attrs[key] = value
        return self

    def get_attr(self, key: str, default=None):
        return self._attrs.get(key, default)

    def apply(self, graph: IrGraph) -> IrGraph:
        self.apply_impl(graph)
        return graph

    def apply_impl(self, graph: IrGraph):
        raise NotImplementedError


_PASS_REGISTRY: Dict[str, Callable[..., Pass]] = {}


def register_pass(name: str):
    """REGISTER_PASS(name) analog; also usable on plain functions
    ``fn(graph)`` which are wrapped into a Pass."""
    def deco(obj):
        if name in _PASS_REGISTRY:
            raise ValueError(f"pass {name!r} already registered")
        if isinstance(obj, type) and issubclass(obj, Pass):
            obj.name = name
            _PASS_REGISTRY[name] = obj
        else:
            def factory(_fn=obj, **attrs):
                class _FnPass(Pass):
                    def apply_impl(self, graph):
                        _fn(graph)
                p = _FnPass(**attrs)
                p.name = name
                return p
            _PASS_REGISTRY[name] = factory
        return obj
    return deco


def new_pass(name: str, **attrs) -> Pass:
    if name not in _PASS_REGISTRY:
        raise KeyError(f"unknown pass {name!r}; registered: "
                       f"{sorted(_PASS_REGISTRY)}")
    return _PASS_REGISTRY[name](**attrs)


def registered_passes() -> List[str]:
    return sorted(_PASS_REGISTRY)


def apply_pass(program: Program, name: str, **attrs) -> Program:
    """One-shot: Program -> graph -> pass -> Program (honors
    FLAGS_check_ir_passes like any one-pass PassManager pipeline)."""
    return PassManager([new_pass(name, **attrs)]).apply(program)


class PassManager:
    """Ordered pass pipeline (ir_pass_manager / PassBuilder analog).

    Under ``FLAGS_check_ir_passes`` the Program IR is verified
    (framework/analysis.py) before the first pass and after every pass;
    a failing verification raises with the name of the offending pass —
    the bisection step the reference does by hand with
    GraphViz dumps per pass."""

    def __init__(self, passes: Sequence = ()):
        self._passes: List[Pass] = [
            new_pass(p) if isinstance(p, str) else p for p in passes]

    def append(self, p) -> "PassManager":
        self._passes.append(new_pass(p) if isinstance(p, str) else p)
        return self

    @property
    def passes(self) -> List[Pass]:
        return list(self._passes)

    def apply(self, program: Program) -> Program:
        from .. import flags as _flags
        check = bool(_flags.get_flag("check_ir_passes"))
        graph = IrGraph(program)
        if check:
            # verify the input too: a program broken BEFORE the
            # pipeline must not be pinned on the first pass
            self._verify(graph, None)
        for p in self._passes:
            p.apply(graph)
            if check:
                self._verify(graph, p.name)
        return graph.to_program()

    @staticmethod
    def _verify(graph: IrGraph, pass_name: Optional[str]):
        from .analysis import verify_program
        result = verify_program(graph._program)
        if not result.ok():
            for d in result.diagnostics:
                d.pass_name = pass_name
            where = (f"IR pass {pass_name!r} broke the program"
                     if pass_name else
                     "program was already invalid before the first pass")
            result.raise_if_errors(
                f"{where} (FLAGS_check_ir_passes=true)")


# ---------------------------------------------------------------------------
# Concrete passes
# ---------------------------------------------------------------------------


_FUSABLE_ACTS = ("relu", "sigmoid", "tanh", "gelu")
_FUSABLE_BINARIES = ("elementwise_add", "elementwise_sub",
                     "elementwise_mul")


@register_pass("fuse_elewise_add_act_pass")
class FuseElemwiseActPass(Pass):
    """binary + activation -> fused_elemwise_activation
    (framework/ir/fuse_elewise_add_act_pass.cc analog): one IR op where
    there were two."""

    def apply_impl(self, graph: IrGraph):
        # fuse one chain per scan and re-find: replace_ops renumbers
        # node indices, so chains found before a rewrite are stale
        changed = True
        while changed:
            changed = False
            for binary in self.get_attr("binaries", _FUSABLE_BINARIES):
                for act in self.get_attr("activations", _FUSABLE_ACTS):
                    chains = graph.find_chains((binary, act))
                    if not chains:
                        continue
                    add_node, act_node = chains[0]
                    mid = add_node.op.output("Out")[0]
                    fused = graph.new_op(
                        "fused_elemwise_activation",
                        {"X": add_node.op.input("X"),
                         "Y": add_node.op.input("Y")},
                        {"Out": act_node.op.output("Out")},
                        {"functor_list": [binary, act],
                         "axis": add_node.op.attr("axis", -1),
                         "act_attrs": dict(act_node.op.attrs),
                         "save_intermediate_out": False})
                    graph.replace_ops(chains[0], fused, drop_vars=[mid])
                    changed = True
                    break
                if changed:
                    break


@register_pass("delete_dropout_op_pass")
class DeleteDropoutPass(Pass):
    """Remove inference-mode dropout ops, rewiring readers of Out to X
    (inference delete_dropout_op_pass analog). Only is_test dropouts in
    upscale_in_train mode are identity; downgrade-mode ones become a
    scale op instead."""

    def apply_impl(self, graph: IrGraph):
        changed = True
        while changed:
            changed = False
            for node in graph.all_op_nodes():
                if node.type != "dropout" or not node.op.attr("is_test"):
                    continue
                x = node.op.input("X")[0]
                out = node.op.output("Out")[0]
                impl = node.op.attr("dropout_implementation",
                                    "downgrade_in_infer")
                if impl == "upscale_in_train":
                    # emit assign rather than a pure rewire: `out` may be
                    # a fetch target with no in-graph reader, and a rewire
                    # would erase the name
                    ident = graph.new_op("assign", {"X": [x]},
                                         {"Out": [out]}, {})
                    graph.replace_ops(
                        [node], ident,
                        drop_vars=[n for n in node.output_names()
                                   if n != out])
                else:
                    keep = 1.0 - float(node.op.attr("dropout_prob", 0.5))
                    scale = graph.new_op(
                        "scale", {"X": [x]}, {"Out": [out]},
                        {"scale": keep, "bias": 0.0})
                    graph.replace_ops(
                        [node], scale,
                        drop_vars=[n for n in node.output_names()
                                   if n != out])
                changed = True
                break


@register_pass("fuse_bn_act_pass")
class FuseBnActPass(Pass):
    """Inference batch_norm + relu -> fused_scale_bias_relu after
    folding BN stats into per-channel scale/bias ops
    (fuse_bn_act_pass / constant-fold analog). Applies only to is_test
    batch_norm (running stats are frozen inputs)."""

    def apply_impl(self, graph: IrGraph):
        # fuse one chain per scan and re-find (indices go stale after
        # each rewrite); loop until a scan finds nothing
        while True:
            chains = [c for c in graph.find_chains(("batch_norm", "relu"),
                                                   out_slot="Y")
                      if c[0].op.attr("is_test")]
            if not chains:
                break
            bn, act = chain = chains[0]
            eps = float(bn.op.attr("epsilon", 1e-5))
            x = bn.op.input("X")[0]
            out = act.op.output("Out")[0]
            # scale' = gamma / sqrt(var + eps); bias' = beta - mean*scale'
            # built as IR ops so it works for any saved params
            from . import unique_name
            sc = unique_name.generate(f"{x}.bn_fold_scale")
            bi = unique_name.generate(f"{x}.bn_fold_bias")
            graph.block.create_var(sc, stop_gradient=True)
            graph.block.create_var(bi, stop_gradient=True)
            var_eps = unique_name.generate(f"{x}.bn_fold_veps")
            graph.block.create_var(var_eps, stop_gradient=True)
            mean_sc = unique_name.generate(f"{x}.bn_fold_msc")
            graph.block.create_var(mean_sc, stop_gradient=True)
            mk = graph.new_op
            pre = [
                mk("scale", {"X": bn.op.input("Variance")},
                   {"Out": [var_eps]}, {"scale": 1.0, "bias": eps}),
                mk("rsqrt", {"X": [var_eps]}, {"Out": [var_eps]}, {}),
                mk("elementwise_mul", {"X": bn.op.input("Scale"),
                                       "Y": [var_eps]},
                   {"Out": [sc]}, {}),
                mk("elementwise_mul", {"X": bn.op.input("Mean"),
                                       "Y": [sc]},
                   {"Out": [mean_sc]}, {}),
                mk("elementwise_sub", {"X": bn.op.input("Bias"),
                                       "Y": [mean_sc]},
                   {"Out": [bi]}, {}),
            ]
            data_layout = bn.op.attr("data_layout", "NCHW")
            fused = mk("fused_scale_bias_relu",
                       {"X": [x], "Scale": [sc], "Bias": [bi]},
                       {"Out": [out]},
                       {"data_layout": data_layout})
            mid = bn.op.output("Y")[0]
            idx = min(n.idx for n in chain)
            ops = [op for i, op in enumerate(graph.block.ops)
                   if i not in {n.idx for n in chain}]
            ops[idx:idx] = pre + [fused]
            graph.block.ops = ops
            graph.block.vars.pop(mid, None)
            graph._rebuild()


__all__ = [
    "IrGraph", "OpNode", "Pass", "PassManager", "apply_pass",
    "new_pass", "register_pass", "registered_passes",
]
