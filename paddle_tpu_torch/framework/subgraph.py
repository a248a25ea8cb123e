"""Subgraph detection + engine delegation — the counterpart of
``paddle_tpu/framework/subgraph.py`` (pattern analog of
framework/ir/subgraph_detector.cc + the TensorRT engine-op bridge
inference/tensorrt/convert + operators/tensorrt_engine_op.h).

The reference clusters maximal regions of "supported" ops and replaces
each with ONE engine op that delegates execution to an external
runtime. The port keeps the three parts of that pattern: (a) a sound
maximal-cluster detector over the IR graph, (b) single-op replacement
carrying the sub-program, (c) a pluggable engine runner. The default
"inline" engine executes the sub-ops through the lowering registry
inside the enclosing run (``ops/delegate_ops.py``; on the card inside
the executor's CUDA-graph capture, so the kernels are those of the ops
it replaced), and a bridge registers its own runner via
``register_delegate_engine``.

Soundness: clustering contracts nodes, which can create cycles (a path
leaving the cluster through an unsupported op and re-entering). The
detector splits any cluster on a contracted cycle by demoting its
topologically-latest node until the contracted graph is a DAG — the
same invariant subgraph_detector.cc maintains with its DFS check.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Set

from .ir import IrGraph, OpNode, Pass, register_pass

# engine name -> runner(sub_ops, ins_dict, ctx) -> outputs dict
_DELEGATE_ENGINES: Dict[str, Callable] = {}


def register_delegate_engine(name: str, runner: Callable):
    """Plug an execution engine for delegated subgraphs. ``runner``
    receives (op_dicts, input_tensors: {name: tensor}, ctx) and returns
    {name: tensor} for the subgraph's external outputs."""
    _DELEGATE_ENGINES[name] = runner


def get_delegate_engine(name: str):
    return _DELEGATE_ENGINES.get(name)


class SubgraphDetector:
    """Maximal clusters of supported ops whose contraction keeps the
    graph acyclic (subgraph_detector.cc:SubgraphDetector)."""

    def __init__(self, graph: IrGraph,
                 is_supported: Callable[[OpNode], bool]):
        self.graph = graph
        self.is_supported = is_supported

    def _op_edges(self):
        """producer-op -> consumer-op adjacency via vars."""
        nodes = self.graph.all_op_nodes()
        succ: Dict[int, Set[int]] = {n.idx: set() for n in nodes}
        for n in nodes:
            for name in n.output_names():
                for c in self.graph.var_consumers(name):
                    if c.idx != n.idx:
                        succ[n.idx].add(c.idx)
        return nodes, succ

    def detect(self, min_size: int = 2) -> List[List[OpNode]]:
        nodes, succ = self._op_edges()
        by_idx = {n.idx: n for n in nodes}
        supported = {n.idx for n in nodes if self.is_supported(n)}

        # 1) union-find over supported-supported edges
        parent = {i: i for i in supported}

        def find(i):
            while parent[i] != i:
                parent[i] = parent[parent[i]]
                i = parent[i]
            return i

        def union(a, b):
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

        for i in supported:
            for j in succ[i]:
                if j in supported:
                    union(i, j)

        def clusters():
            out: Dict[int, List[int]] = {}
            for i in supported:
                out.setdefault(find(i), []).append(i)
            return out

        # 2) contracted-graph cycle check; split offending clusters by
        #    demoting their topologically-latest member
        def contracted_cyclic(cl: Dict[int, List[int]]):
            rep = {}
            for r, mem in cl.items():
                for i in mem:
                    rep[i] = ("c", r)
            cg: Dict[object, Set[object]] = {}
            for i, js in succ.items():
                a = rep.get(i, ("n", i))
                for j in js:
                    b = rep.get(j, ("n", j))
                    if a != b:
                        cg.setdefault(a, set()).add(b)
                        cg.setdefault(b, set())
            # DFS cycle detection returning one cluster on a cycle
            WHITE, GRAY, BLACK = 0, 1, 2
            color = {v: WHITE for v in cg}
            stack: List[object] = []

            def dfs(v):
                color[v] = GRAY
                stack.append(v)
                for w in cg.get(v, ()):
                    if color[w] == GRAY:
                        for s in reversed(stack):
                            if s[0] == "c":
                                return s[1]
                        return None
                    if color[w] == WHITE:
                        r = dfs(w)
                        if r is not None:
                            return r
                color[v] = BLACK
                stack.pop()
                return None

            for v in list(cg):
                if color[v] == WHITE:
                    r = dfs(v)
                    if r is not None:
                        return r
            return None

        cl = clusters()
        while True:
            bad = contracted_cyclic(cl)
            if bad is None:
                break
            members = cl[bad]
            if len(members) <= 1:
                # singleton can't cycle in a DAG; defensive
                break
            demote = max(members)        # topologically latest op idx
            members.remove(demote)
            # demoted node becomes its own cluster root
            parent[demote] = demote
            for i in members:
                parent[i] = members[0]
            parent[members[0]] = members[0]
            cl = clusters()

        return [sorted((by_idx[i] for i in mem), key=lambda n: n.idx)
                for mem in cl.values() if len(mem) >= min_size]


@register_pass("subgraph_delegate_pass")
class SubgraphDelegatePass(Pass):
    """Replace each detected cluster with one ``subgraph_delegate`` op
    (tensorrt_engine_op.h analog). Attrs: ``is_supported`` predicate
    (op-type set or callable), ``min_subgraph_size``, ``engine``."""

    def apply_impl(self, graph: IrGraph):
        pred = self.get_attr("is_supported")
        if isinstance(pred, (set, frozenset, list, tuple)):
            types = set(pred)
            pred = lambda n: n.type in types      # noqa: E731
        min_size = int(self.get_attr("min_subgraph_size", 2))
        engine = self.get_attr("engine", "inline")
        # replace ONE cluster per detection round: node indices go stale
        # the moment the op list is rewritten
        while True:
            clusters = SubgraphDetector(graph, pred).detect(min_size)
            if not clusters:
                break
            cluster = clusters[0]
            member_idx = {n.idx for n in cluster}
            produced: Set[str] = set()
            consumed: Set[str] = set()
            for n in cluster:
                produced.update(n.output_names())
                consumed.update(n.input_names())
            ext_in = sorted(consumed - produced)
            ext_out = sorted(
                name for name in produced
                if any(c.idx not in member_idx
                       for c in graph.var_consumers(name))
                or graph.block.vars.get(name) is not None
                and graph.block.vars[name].persistable
                or not graph.var_consumers(name))   # graph outputs too
            sub_ops = [{"type": n.op.type,
                        "inputs": {k: list(v)
                                   for k, v in n.op.inputs.items()},
                        "outputs": {k: list(v)
                                    for k, v in n.op.outputs.items()},
                        "attrs": dict(n.op.attrs)} for n in cluster]
            delegate = graph.new_op(
                "subgraph_delegate",
                inputs={"X": ext_in}, outputs={"Out": ext_out},
                attrs={"sub_ops": json.dumps(sub_ops),
                       "input_names": ext_in, "output_names": ext_out,
                       "engine": engine})
            graph.replace_ops(cluster, delegate)
        return graph


__all__ = ["SubgraphDetector", "SubgraphDelegatePass",
           "register_delegate_engine", "get_delegate_engine"]
