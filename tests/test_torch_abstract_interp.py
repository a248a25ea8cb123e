"""The port's abstract interpreter (``paddle_tpu_torch/analysis/
abstract_interp.py``: the lowerings run on meta tensors) against the JAX
package's (``paddle_tpu/analysis/abstract_interp.py``: ``jax.eval_shape``)
and the executor's compile predictor against the executor's own count.

- every op case of the library (``test_torch_static.OP_CASES`` and
  ``torch_op_cases_tail.TAIL_CASES``): the same ``AbstractVar`` per
  output (shape and dtype), JAX with 64-bit types on as the suite runs
  it; a sample of the generic ``<op>_grad`` ops likewise;
- the programs of ``tests/test_abstract_interp.py``, built with each
  package's own builders: the same ``AbstractVar`` per variable and the
  same diagnostics (check, severity, block, op index, variable), the
  control-flow rules (loop-carry drift, branch mismatch) and the waiting
  ops' rules (collectives by ``nranks``, the PS tier) included, and the
  eight Book programs (``models/book.py``) with every op inferred;
- ``ExecutorCompilePredictor`` against the port's ``executor_step``
  count on ``Executor("cpu")``.

Pinned divergences (ROADMAP C): under the reference's 64-bit types the
floating outputs of ``auc``, ``density_prior_box`` and the two
``*_random_batch_size_like`` ops are float64, the port's float32
(:data:`X64_FLOAT`); ``masked_select`` and ``where_index`` have
value-dependent shapes and refuse in both packages.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import types
import zlib

import numpy as np
import pytest

import paddle_tpu
from paddle_tpu import flags as jflags
from paddle_tpu import layers as JL
from paddle_tpu.analysis import abstract_interp as JA
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.ops import registry as jreg
from paddle_tpu.optimizer import SGDOptimizer as JSGD

import paddle_tpu_torch
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import layers as TL
from paddle_tpu_torch.analysis import ExecutorCompilePredictor
from paddle_tpu_torch.analysis import abstract_interp as TA
from paddle_tpu_torch.framework import (Executor, Program, ProgramVerifyError,
                                        Scope, program_guard, unique_name)
from paddle_tpu_torch.models import book
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.optimizer import SGDOptimizer as TSGD

import test_torch_static as S
from torch_op_cases_tail import TAIL_CASES

JAX = types.SimpleNamespace(L=JL, P=JProgram, guard=jguard, un=jun, A=JA,
                            SGD=JSGD, flags=jflags)
PORT = types.SimpleNamespace(L=TL, P=Program, guard=program_guard,
                             un=unique_name, A=TA, SGD=TSGD, flags=tflags)

#: output slots whose dtype is float64 under the reference's 64-bit types
#: and float32 in the port (ROADMAP C)
X64_FLOAT = {"auc": {"AUC"}, "density_prior_box": {"Boxes", "Variances"},
             "gaussian_random_batch_size_like": {"Out"},
             "uniform_random_batch_size_like": {"Out"}}
#: value-dependent output shapes: both packages refuse them
REFUSED = {"masked_select", "where_index"}
#: control flow runs its sub-blocks: the program tests below cover it
SUB_BLOCK_OPS = {"while", "cond", "switch_case"}

CASES = {**S.OP_CASES, **TAIL_CASES}
OP_CASE_NAMES = sorted(c for c in CASES if CASES[c][0] not in SUB_BLOCK_OPS)


def _avs(A, vals):
    return {s: [A.AbstractVar(tuple(np.shape(a)), str(np.asarray(a).dtype))
                for a in v] for s, v in vals.items()}


def _eval(pkg, op_type, ins, attrs):
    """The package's transfer function for one op: its infer rule where
    it has one, else its abstract run of the lowering."""
    if pkg is JAX:
        d = jreg.OPS.get(op_type)
    else:
        d = treg.declared(op_type)
    if d is not None and d.infer is not None:
        outs = d.infer(None, _avs(pkg.A, ins), dict(attrs))
    else:
        outs = pkg.A.abstract_eval_op(op_type, _avs(pkg.A, ins), dict(attrs))
    return {s: [(v.shape, v.dtype) for v in vs] for s, vs in outs.items()}


def _pinned(op_type, jout, tout):
    """``jout`` with the pinned x64 dtypes put to the port's."""
    out = {}
    for s, vs in jout.items():
        if s in X64_FLOAT.get(op_type, ()):
            assert [d for _, d in vs] == ["float64"] * len(vs), (s, vs)
            vs = [(shape, "float32") for shape, _ in vs]
        out[s] = vs
    return out


@pytest.mark.parametrize("case", OP_CASE_NAMES)
def test_op_case_infers_like_jax(case):
    op_type, make, attrs = CASES[case][:3]
    ins = make(np.random.RandomState(zlib.crc32(case.encode())))
    if op_type in REFUSED:
        with pytest.raises(NotImplementedError):
            _eval(JAX, op_type, ins, attrs)
        with pytest.raises(NotImplementedError):
            _eval(PORT, op_type, ins, attrs)
        return
    jout = _eval(JAX, op_type, ins, attrs)
    tout = _eval(PORT, op_type, ins, attrs)
    assert tout == _pinned(op_type, jout, tout)


#: every fourth differentiable case: the generic ``<op>_grad`` on meta
GRAD_CASES = [c for c in sorted(S.OP_CASES)
              if not treg.get_op_def(S.OP_CASES[c][0]).not_differentiable
              and treg.get_op_def(S.OP_CASES[c][0]).infer is None
              and c not in S._NO_GRAD and c not in S._RAISES
              and c not in S._EAGER][::4]


def test_generic_grad_ops_infer_like_jax():
    checked = 0
    for case in GRAD_CASES:
        op_type, make, attrs = S.OP_CASES[case][:3]
        ins = make(np.random.RandomState(zlib.crc32(case.encode())))
        outs, _ = S._run("port", op_type, ins, attrs, None)
        fw, out_g, wanted = S._grad_desc(treg, op_type, ins, outs)
        fw.attrs = dict(attrs)
        vals = {f"{s}:{i}": np.asarray(v) for s, vs in ins.items()
                for i, v in enumerate(vs)}
        vals.update({f"{s}:{i}": v for s, vs in outs.items()
                     for i, v in enumerate(vs)})
        vals.update({f"{s}:{i}@G": v for s, vs in outs.items()
                     for i, v in enumerate(vs)})
        for g_type, g_in, _, g_attrs in treg.make_grad_ops(fw, out_g, wanted):
            gins = {s: [vals[n] for n in names] for s, names in g_in.items()}
            assert _eval(PORT, g_type, gins, g_attrs) == \
                _eval(JAX, g_type, gins, g_attrs), case
            checked += 1
    assert checked >= 40


# ---------------------------------------------------------------------
# programs, built in both packages
# ---------------------------------------------------------------------


def _build(pkg, fn):
    main, startup = pkg.P(), pkg.P()
    with pkg.guard(main, startup), pkg.un.guard():
        out = fn(pkg)
    return main, startup, out


def _shapes(r):
    return {k: (v.shape, v.dtype) for k, v in r.var_shapes.items()}


def _diags(r):
    return [(d.check, d.severity, d.block_idx, d.op_idx, d.var)
            for d in r.diagnostics]


def _both(fn, **kw):
    """Interpret ``fn``'s program in each package; the results, held to
    the same shapes and diagnostics."""
    jm, _, jout = _build(JAX, fn)
    tm, _, tout = _build(PORT, fn)
    jr = JA.interpret_program(jm, **kw)
    tr = TA.interpret_program(tm, **kw)
    assert _shapes(tr) == _shapes(jr)
    assert _diags(tr) == _diags(jr)
    assert [u[0] for u in tr.unknown_ops] == [u[0] for u in jr.unknown_ops]
    assert tr.ops_inferred == jr.ops_inferred
    return tm, tr, tout


def _mis_shaped_matmul(p):
    a = p.L.data("a", [4])
    w = p.L.create_parameter([8, 5], "float32")
    return p.L.matmul(a, w)


def test_mis_shaped_matmul_reports_op_and_dims():
    _, r, _ = _both(_mis_shaped_matmul)
    (d,) = r.errors
    assert (d.check, d.severity, d.block_idx, d.op_idx) == (
        "shapes.infer", "error", 0, 0)
    assert "matmul" in d.message
    assert "4" in d.message and "8,5" in d.message.replace(" ", "")


def test_elementwise_shape_mismatch_caught():
    def build(p):
        return p.L.elementwise_add(p.L.data("a", [4]), p.L.data("b", [6]))

    _, r, _ = _both(build)
    (d,) = r.errors
    assert "elementwise_add" in d.message


def test_grad_ops_mirror_forward_shapes():
    def build(p):
        x = p.L.data("x", [4])
        y = p.L.data("y", [1])
        pred = p.L.fc(x, 1)
        loss = p.L.mean(p.L.square_error_cost(pred, y))
        p.SGD(0.1).minimize(loss)
        return loss

    _, r, _ = _both(build)
    assert not r.unknown_ops and not r.errors
    checked = 0
    for (bidx, name), av in r.var_shapes.items():
        if "@GRAD" not in name or not av.known:
            continue
        fwd = r.var_shapes.get((bidx, name.split("@GRAD", 1)[0]))
        if fwd is not None and fwd.known:
            assert av.shape == fwd.shape, (name, av, fwd)
            checked += 1
    assert checked >= 3


def _fc(p):
    return p.L.fc(p.L.data("x", [4]), 3)


def test_dynamic_batch_and_fed_shapes():
    _, r, out = _both(_fc)
    assert (r.shape_of(out.name).shape, r.shape_of(out.name).dtype) == (
        (-1, 3), "float32")
    _, r, out = _both(_fc, feeds={"x": ((16, 4), "float32")})
    assert r.shape_of(out.name).shape == (16, 3)


def _while(p):
    L = p.L
    i = L.fill_constant([1], "int32", 0)
    ten = L.fill_constant([1], "int32", 10)
    out = L.while_loop(
        lambda i: L.less_than(i, ten),
        lambda i: [L.elementwise_add(i, L.fill_constant([1], "int32", 1))],
        [i])
    return out[0] if isinstance(out, (list, tuple)) else out


def _corrupt_while(main):
    wop = next(op for b in main.blocks for op in b.ops if op.type == "while")
    cname = wop.attrs["carry_names"][0]
    main.blocks[int(wop.attrs["sub_block"])].append_op(
        "concat", {"X": [cname, cname]}, {"Out": cname}, {"axis": 0})
    return cname


def test_while_loop_infers_and_flags_carry_drift():
    tm, r, out = _both(_while)
    assert not r.errors and not r.unknown_ops
    assert (r.shape_of(out.name).shape, r.shape_of(out.name).dtype) == (
        (1,), "int32")
    jm, _, _ = _build(JAX, _while)
    cname = _corrupt_while(tm)
    _corrupt_while(jm)
    r2, jr2 = TA.interpret_program(tm), JA.interpret_program(jm)
    assert _diags(r2) == _diags(jr2)
    (bad,) = [d for d in r2.diagnostics if d.check == "shapes.loop-carry"]
    assert bad.severity == "error" and cname in bad.message
    assert "int32[1]" in bad.message and "int32[2]" in bad.message


def _cond(p):
    L = p.L
    x = L.data("x", [4])
    pred = L.less_than(L.mean(x), L.fill_constant([1], "float32", 0.0))
    return L.cond(pred, lambda: L.elementwise_add(x, x),
                  lambda: L.elementwise_mul(x, x))


def _corrupt_cond(main):
    cop = next(op for b in main.blocks for op in b.ops if op.type == "cond")
    oname = cop.attrs["out_names"][0]
    main.blocks[int(cop.attrs["sub_block_f"])].append_op(
        "concat", {"X": [oname, oname]}, {"Out": oname}, {"axis": 0})
    return oname


def test_cond_branch_mismatch_flagged():
    tm, r, out = _both(_cond)
    assert not r.errors and r.shape_of(out.name).shape == (-1, 4)
    jm, _, _ = _build(JAX, _cond)
    oname = _corrupt_cond(tm)
    _corrupt_cond(jm)
    r2, jr2 = TA.interpret_program(tm), JA.interpret_program(jm)
    assert _diags(r2) == _diags(jr2)
    (bad,) = [d for d in r2.diagnostics if d.check == "shapes.branch-mismatch"]
    assert oname in bad.message


def _switch(p):
    L = p.L
    x = L.data("x", [4])
    idx = L.fill_constant([1], "int32", 1)
    return L.switch_case(idx, {0: lambda: L.scale(x, 2.0),
                               1: lambda: L.elementwise_add(x, x)},
                         default=lambda: L.relu(x))


def test_switch_case_infers_like_jax():
    _, r, out = _both(_switch)
    assert not r.errors and r.shape_of(out.name).shape == (-1, 4)


def _waiting_ops_program(P, nranks_bad=False):
    prog = P()
    blk = prog.global_block()
    blk.create_var("x", is_data=True, shape=[8, 3], dtype="float32")
    for name, op_type, nranks in [("g", "c_allgather", 4),
                                  ("s", "c_reducescatter", 4),
                                  ("r", "c_allreduce_sum", 4),
                                  ("sp", "c_split", 3)]:
        blk.create_var(name)
        blk.append_op(op_type, {"X": "x"}, {"Out": name}, {"nranks": nranks})
    blk.create_var("ids", is_data=True, shape=[4, 1], dtype="int64")
    blk.create_var("emb")
    blk.append_op("distributed_lookup_table", {"Ids": "ids"},
                  {"Out": "emb"},
                  {"table_name": "interp_test_table", "value_dim": 16})
    blk.create_var("rx")
    blk.append_op("recv", {}, {"Out": "rx"},
                  {"recv_varnames": ["v"], "shape": [3, 5]})
    blk.create_var("tok")
    blk.append_op("send", {"X": "x"}, {"Out": "tok"},
                  {"send_varnames": ["v"]})
    blk.create_var("w", is_data=True, shape=[10, 6], dtype="float32")
    blk.create_var("ce")
    blk.append_op("c_embedding", {"W": "w", "Ids": "ids"}, {"Out": "ce"}, {})
    blk.create_var("bar")
    blk.append_op("barrier", {}, {"Out": "bar"}, {})
    if nranks_bad:
        blk.create_var("bad")
        blk.append_op("c_reducescatter", {"X": "x"}, {"Out": "bad"},
                      {"nranks": 3})              # 8 % 3 != 0
    return prog


def test_waiting_ops_rules_like_the_reference():
    """The collectives wait for A5 in the port and the PS ops are host
    ops; the rules of both give the reference's shapes, and the PS pull,
    run, fills the rule's shape from a host table."""
    for bad in (False, True):
        jr = JA.interpret_program(_waiting_ops_program(JProgram, bad))
        tr = TA.interpret_program(_waiting_ops_program(Program, bad))
        assert _shapes(tr) == _shapes(jr)
        assert _diags(tr) == _diags(jr)
        assert not tr.unknown_ops
    r = TA.interpret_program(_waiting_ops_program(Program))
    assert not r.errors
    assert r.shape_of("g").shape == (32, 3)
    assert r.shape_of("s").shape == (2, 3)
    assert r.shape_of("r").shape == (8, 3)
    assert r.shape_of("sp").shape == (8, 1)
    assert r.shape_of("emb").shape == (4, 1, 16)
    assert r.shape_of("rx") == TA.AbstractVar((3, 5), "float32")
    assert r.shape_of("ce").shape == (4, 1, 6)
    errs = TA.interpret_program(_waiting_ops_program(Program, True)).errors
    assert len(errs) == 1 and "divisible" in errs[0].message
    # the PS pull (A7.4) runs on a host table, with the rule's shape
    from paddle_tpu_torch.distributed.ps import REGISTRY
    try:
        out = treg.execute(treg.LoweringContext(device="cpu"),
                           "distributed_lookup_table",
                           {"Ids": [np.array([3, 5], np.int64)]},
                           {"value_dim": 4, "table_names": ["interp_t"]})
        assert tuple(out["Out"][0].shape) == (2, 4)
        np.testing.assert_array_equal(
            out["Out"][0].numpy(),
            REGISTRY.get("interp_t").pull(np.array([3, 5], np.int64)))
    finally:
        REGISTRY.clear()


def test_unknown_op_is_warning_not_error():
    def prog(P):
        p = P()
        blk = p.global_block()
        blk.create_var("x", is_data=True, shape=[2], dtype="float32")
        blk.create_var("y")
        blk.append_op("totally_unregistered_op", {"X": "x"}, {"Out": "y"})
        return p

    jr, r = JA.interpret_program(prog(JProgram)), TA.interpret_program(
        prog(Program))
    assert _diags(r) == _diags(jr)
    assert [u[0] for u in r.unknown_ops] == ["totally_unregistered_op"]
    assert not r.errors and r.shape_of("y") == TA.AbstractVar()


def _py_func(p):
    x = p.L.data("x", [3])
    y = x.block.create_var(name="py_out", shape=[-1, 3], dtype="float32")
    p.L.py_func(lambda a: a * 2.0, x, y)
    return p.L.reduce_sum(y)


def test_py_func_takes_its_declared_output_shapes():
    """A host op's function cannot run on meta tensors: its outputs take
    their declared shapes, the batch dim the first input's (the
    reference's ``pure_callback`` templates)."""
    _, r, out = _both(_py_func)
    assert not r.errors and r.shape_of("py_out").shape == (-1, 3)
    _, r, _ = _both(_py_func, feeds={"x": ((5, 3), "float32")})
    assert r.shape_of("py_out") == TA.AbstractVar((5, 3), "float32")


SIZES = {
    "fit_a_line": {}, "recognize_digits": dict(batch_size=8),
    "word2vec": {}, "image_classification": dict(depth=8, batch_size=4),
    "label_semantic_roles": dict(hidden_dim=16, depth=2, batch_size=4),
    "recommender_system": dict(batch_size=16),
    "rnn_encoder_decoder": dict(batch_size=4),
    "machine_translation": dict(batch_size=4),
}


@pytest.mark.parametrize("name", list(book.PROGRAMS))
def test_book_programs_infer_every_op_like_jax(name):
    jb = book.PROGRAMS[name](paddle_tpu, **SIZES[name])
    tb = book.PROGRAMS[name](paddle_tpu_torch, **SIZES[name])
    jr, r = JA.interpret_program(jb.main), TA.interpret_program(tb.main)
    assert not r.unknown_ops and not r.errors, r.diagnostics
    assert r.ops_inferred == sum(len(b.ops) for b in tb.main.blocks)
    assert _shapes(r) == _shapes(jr)
    assert _diags(r) == _diags(jr)


# ---------------------------------------------------------------------
# the verifier's shapes check and the executor
# ---------------------------------------------------------------------


def test_shapes_check_gated_behind_flag():
    from paddle_tpu_torch.framework.analysis import ANALYSIS_CHECKS
    main, _, _ = _build(PORT, _mis_shaped_matmul)
    saved = tflags.get_flags(["check_shapes"])
    try:
        tflags.set_flags({"check_shapes": False})
        assert "shapes.infer" in ANALYSIS_CHECKS
        assert main.verify().ok()
        r = main.verify(checks=["shapes.infer"])
        assert not r.ok() and r.errors[0].check == "shapes.infer"
        tflags.set_flags({"check_shapes": True})
        assert not main.verify().ok()
    finally:
        tflags.set_flags(saved)


def test_executor_first_run_catches_mis_shape_under_flag():
    main, startup, out = _build(PORT, _mis_shaped_matmul)
    scope, exe = Scope(), Executor("cpu")
    exe.run(startup, scope=scope)
    saved = tflags.get_flags(["check_shapes"])
    try:
        tflags.set_flags({"check_shapes": True})
        with pytest.raises(ProgramVerifyError) as ei:
            exe.run(main, feed={"a": np.zeros((2, 4), np.float32)},
                    fetch_list=[out.name], scope=scope)
    finally:
        tflags.set_flags(saved)
    assert "shapes.infer" in str(ei.value)


def test_executor_predictor_matches_observed_compiles():
    from paddle_tpu_torch.observability import compile_tracker as ct
    main, startup, out = _build(PORT, _fc)
    scope, exe = Scope(), Executor("cpu")
    exe.run(startup, scope=scope)

    def count():
        return ct.compiles().get("executor_step", {}).get("count", 0)

    pred = ExecutorCompilePredictor()
    for rows in (2, 2, 6, 6, 2):
        arr = np.zeros((rows, 4), np.float32)
        before = count()
        predicted = pred.would_compile(main, {"x": arr}, [out.name], scope)
        exe.run(main, feed={"x": arr}, fetch_list=[out.name], scope=scope)
        assert (count() - before == 1) == predicted, rows
    assert pred.predicted_counts() == {"executor_step": 2}
    with pytest.raises(NotImplementedError, match="A5"):
        pred.would_compile(main, {"x": arr}, [out.name], scope,
                           mesh_shape=(2,))


@pytest.mark.parametrize("name", ["recognize_digits", "label_semantic_roles"])
def test_interpreted_shapes_are_the_run_values(name):
    """Every concrete shape the interpreter gives a Book program at its
    feed shapes is that of the value the CPU run writes under the same
    name (``executor.observe_values``), as phase 28 (d) of
    ``chip_smoke.py`` holds the card's tensors."""
    from paddle_tpu_torch.framework import executor as ex
    b = book.PROGRAMS[name](paddle_tpu_torch, seed=3, **SIZES[name])
    scope, exe = Scope(), Executor("cpu")
    exe.run(b.startup, scope=scope)
    (feed,) = book.batches(b, 1)
    seen = {}

    def observe(program, block_idx, var, value):
        if program is b.main:
            seen.setdefault((block_idx, var), tuple(value.shape))

    with ex.observe_values(observe):
        exe.run(b.main, feed=feed, fetch_list=[v.name for v in b.fetches],
                scope=scope)
    r = TA.interpret_program(b.main, feeds={
        k: (np.shape(v), str(np.asarray(v).dtype)) for k, v in feed.items()})
    compared = 0
    for key, av in r.var_shapes.items():
        if av.concrete and key in seen:
            assert av.shape == seen[key], key
            compared += 1
    assert compared >= 0.9 * len(seen)
