"""DynamicRNN — the step-programmable decoder loop; a copy of
``paddle_tpu/layers/dynamic_rnn.py``.

Analog of fluid.layers.DynamicRNN (python/paddle/fluid/layers/
control_flow.py DynamicRNN: step_input / static_input / memory /
update_memory / output inside ``with rnn.block():``; fluid lowers the
block to a while op walking LoD ranks). Here, as in the JAX package, the
loop is UNROLLED under the padded+lengths design: the user body records
ONCE into a scratch Program (its parameters land in the enclosing
startup program, so the weights are created once and shared), then
``rnn()`` clones the recorded ops into the outer Program T times: step
t reads slice t of every step_input, chains the memories t-1 -> t, and
the per-step outputs stack to ``[batch, T, d]``. Every shape is static,
so the executor captures the unrolled decoder in the step's one CUDA
graph.

Contract differences from fluid, by design (the reference's):
- sequences are padded ``[batch, T, ...]`` (no LoD); per-row lengths
  beyond T are the caller's masking concern;
- ``drnn.memory(init=...)`` requires an explicit init var;
- ``rnn()`` returns the stacked padded outputs, not a LoD tensor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..framework import program_guard, unique_name
from ..framework.program import (Program, Variable,
                                 default_main_program,
                                 default_startup_program)


class DynamicRNN:
    def __init__(self, name: Optional[str] = None):
        self._name = name or unique_name.generate("dynamic_rnn")
        self._sub = Program()
        self._guard = None
        self._recorded = False
        # placeholder name -> (outer seq var, per-step shape)
        self._step_inputs: Dict[str, Variable] = {}
        self._static_inputs: Dict[str, Variable] = {}
        # placeholder name -> (init outer var, update sub-var name)
        self._memories: Dict[str, List] = {}
        self._outputs: List[str] = []
        self._maxlen: Optional[int] = None
        self._result = None

    # -- recording phase -------------------------------------------------

    def block(self):
        """Context manager: record the step body once. Ops land in the
        scratch sub-program; parameters initialize in the REAL startup
        program (created once, shared by every unrolled step)."""
        outer_startup = default_startup_program()
        drnn = self

        class _Guard:
            def __enter__(self):
                drnn._pg = program_guard(drnn._sub, outer_startup)
                drnn._pg.__enter__()
                return drnn

            def __exit__(self, *exc):
                drnn._pg.__exit__(*exc)
                drnn._recorded = True
                return False

        return _Guard()

    def _placeholder(self, kind: str, like_shape, dtype) -> Variable:
        name = unique_name.generate(f"{self._name}.{kind}")
        v = self._sub.global_block().create_var(
            name, shape=list(like_shape), dtype=dtype)
        return v

    def step_input(self, seq: Variable):
        """Register a padded [b, T, ...] sequence; returns the per-step
        [b, ...] view inside the block."""
        if seq.shape is None or len(seq.shape) < 2:
            raise ValueError("step_input needs a [batch, T, ...] var")
        t = int(seq.shape[1])
        if self._maxlen is None:
            self._maxlen = t
        elif self._maxlen != t:
            raise ValueError(
                f"step_input time dims disagree: {self._maxlen} vs {t}")
        step_shape = [seq.shape[0]] + list(seq.shape[2:])
        v = self._placeholder("step_in", step_shape, seq.dtype)
        self._step_inputs[v.name] = seq
        return v

    def static_input(self, x: Variable):
        """A per-step constant (same value every step)."""
        v = self._placeholder("static_in", list(x.shape or []), x.dtype)
        self._static_inputs[v.name] = x
        return v

    def memory(self, init: Variable, need_reorder: bool = False):
        """Recurrent state seeded by ``init`` (a [b, d] outer var)."""
        v = self._placeholder("mem", list(init.shape or []), init.dtype)
        self._memories[v.name] = [init, None]
        return v

    def update_memory(self, mem: Variable, new: Variable):
        if mem.name not in self._memories:
            raise ValueError(f"{mem.name} is not a DynamicRNN memory")
        self._memories[mem.name][1] = new.name

    def output(self, *outs: Variable):
        self._outputs.extend(o.name for o in outs)

    # -- unroll phase ----------------------------------------------------

    def __call__(self):
        if not self._recorded:
            raise RuntimeError("call rnn() after `with rnn.block():`")
        if self._result is not None:
            return self._result
        if self._maxlen is None:
            raise RuntimeError("DynamicRNN needs at least one step_input")
        for name, (init, upd) in self._memories.items():
            if upd is None:
                raise RuntimeError(
                    f"memory {name} was never update_memory()'d")
        from .nn_veneer import slice as _slice, squeeze as _squeeze, \
            stack as _stack

        outer = default_main_program().global_block()
        sub = self._sub.global_block()

        # parameters created inside the block move to the outer program
        for v in sub.vars.values():
            if v.is_parameter:
                p = outer.create_parameter(
                    v.name, shape=list(v.shape), dtype=v.dtype,
                    trainable=v.trainable)
                p.initializer = v.initializer
                p.regularizer = getattr(v, "regularizer", None)

        mem_current = {name: init for name, (init, _)
                       in self._memories.items()}
        step_outs: Dict[str, List[Variable]] = {n: []
                                                for n in self._outputs}
        T = self._maxlen
        for t in range(T):
            rename: Dict[str, str] = {}
            for ph, seq in self._step_inputs.items():
                s = _slice(seq, axes=[1], starts=[t], ends=[t + 1])
                s.shape = tuple([seq.shape[0], 1] + list(seq.shape[2:]))
                s = _squeeze(s, [1])
                s.shape = tuple([seq.shape[0]] + list(seq.shape[2:]))
                rename[ph] = s.name
            for ph, x in self._static_inputs.items():
                rename[ph] = x.name
            for ph in self._memories:
                rename[ph] = mem_current[ph].name

            def mapped(n: str) -> str:
                if n in rename:
                    return rename[n]
                v = sub.vars.get(n)
                if v is None:
                    # an OUTER var the body captured directly (the
                    # reference DynamicRNN tolerates this; it behaves
                    # like an implicit static_input)
                    return n
                if v.is_parameter:
                    return n
                return f"{n}@{self._name}.t{t}"

            for op in sub.ops:
                ins = {slot: [mapped(n) for n in names]
                       for slot, names in op.inputs.items()}
                outs = {}
                for slot, names in op.outputs.items():
                    outs[slot] = []
                    for n in names:
                        nn = mapped(n)
                        src = sub.vars.get(n)
                        ov = outer.create_var(
                            nn,
                            dtype=getattr(src, "dtype", "float32"))
                        if src is not None and src.shape is not None:
                            ov.shape = tuple(src.shape)
                        outs[slot].append(nn)
                    # keep declared shapes for downstream builders
                outer.append_op(op.type, ins, outs, dict(op.attrs))
            # advance memories and collect outputs
            for ph, (init, upd) in self._memories.items():
                mem_current[ph] = outer.vars[mapped(upd)]
            for n in self._outputs:
                step_outs[n].append(outer.vars[mapped(n)])

        results = []
        for n in self._outputs:
            stacked = _stack(step_outs[n], axis=1)   # [b, T, d]
            first = step_outs[n][0]
            if first.shape is not None:
                stacked.shape = tuple([first.shape[0], T]
                                      + list(first.shape[1:]))
            results.append(stacked)
        self._result = results[0] if len(results) == 1 else tuple(results)
        return self._result


__all__ = ["DynamicRNN"]
