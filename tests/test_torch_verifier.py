"""The static Program verifier of the port (``paddle_tpu_torch/framework/
analysis.py``) against the JAX package's (``paddle_tpu/framework/
analysis.py``) on the programs of ``tests/test_program_verifier.py``.

Each program is built twice, with each package's own Program API, and
verified by each package's own ``verify_program``: both give the same
diagnostics, compared as (check, severity, block, op index, variable)
in order. Beside that parity the reference's own assertions are made on
the port's result, and the integrations are held as the reference holds
them: ``Program.verify``, ``FLAGS_check_program`` at the executor's first
run of a program (``Executor("cpu")``) and ``FLAGS_check_ir_passes``
around every pass of a ``PassManager``. The eight Book programs
(``paddle_tpu_torch.models.book``, built in both packages) verify with
the same diagnostics: none on their main programs.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import types

import numpy as np
import torch
import pytest

import paddle_tpu
from paddle_tpu import flags as jflags
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import ir as jir
from paddle_tpu.framework import verify_program as jverify
from paddle_tpu.framework.analysis import ANALYSIS_CHECKS as JCHECKS

import paddle_tpu_torch
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.framework import (Executor, Program, ProgramVerifyError,
                                        Scope, verify_program)
from paddle_tpu_torch.framework import analysis as tfa
from paddle_tpu_torch.framework import ir
from paddle_tpu_torch.framework.analysis import ANALYSIS_CHECKS
from paddle_tpu_torch.models import book

JAX = types.SimpleNamespace(Program=JProgram, verify=jverify)
PORT = types.SimpleNamespace(Program=Program, verify=verify_program)


def _key(result):
    return [(d.check, d.severity, d.block_idx, d.op_idx, d.var)
            for d in result.diagnostics]


def _find(result, check, severity=None):
    return [d for d in result.diagnostics
            if d.check == check
            and (severity is None or d.severity == severity)]


# ---------------------------------------------------------------------
# the reference's programs, one builder each: (program, verify kwargs)
# ---------------------------------------------------------------------


def _undefined_input_var(P):
    prog = P.Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 2.0})
    blk.create_var("z")
    blk.append_op("elementwise_add", {"X": "y", "Y": "ghost"},
                  {"Out": "z"})
    return prog, {}


def _unregistered_op_type(P):
    prog = P.Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("scale", {"X": "x"}, {"Out": "y"})
    blk.append_op("definitely_not_an_op", {"X": "y"}, {"Out": "z"})
    blk.create_var("z")
    return prog, {}


def _derived_grad_op(P):
    prog = P.Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("tanh", {"X": "x"}, {"Out": "y"})
    blk.create_var("y@GRAD", is_data=True)
    blk.create_var("x@GRAD")
    blk.append_op("tanh_grad", {"Out": ["y"], "Out@GRAD": ["y@GRAD"]},
                  {"X@GRAD": ["x@GRAD"]})
    return prog, {}


def _dangling_sub_block(P):
    prog = P.Program()
    blk = prog.global_block()
    blk.create_var("c", is_data=True)
    blk.append_op("while", {"Condition": "c"}, {}, {"sub_block": 7})
    return prog, {}


def _cyclic_sub_blocks(P):
    prog = P.Program()
    b0 = prog.global_block()
    b1 = prog._create_block()
    prog._rollback()
    b0.create_var("c", is_data=True)
    b0.append_op("while", {"Condition": "c"}, {}, {"sub_block": 1})
    b1.append_op("while", {"Condition": "c"}, {}, {"sub_block": 0})
    return prog, {}


def _bad_slot_and_dtype(P):
    prog = P.Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    op = blk.append_op("scale", {"X": "x"}, {"Out": "y"})
    op.inputs["X"] = "x"
    blk.create_var("w").dtype = "float13"
    return prog, {}


def _write_after_write(P):
    prog = P.Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 2.0})
    blk.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 3.0})
    blk.create_var("z")
    blk.append_op("scale", {"X": "y"}, {"Out": "z"})
    return prog, {}


def _dead_op(P):
    prog = P.Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 2.0})
    blk.create_var("dead")
    blk.append_op("scale", {"X": "x"}, {"Out": "dead"}, {"scale": 3.0})
    return prog, {}


def _grad_pairing(P):
    prog = P.Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("x@GRAD", is_data=True)
    blk.create_var("orphan@GRAD", is_data=True)
    blk.create_var("s")
    blk.append_op("elementwise_add",
                  {"X": "x@GRAD", "Y": "orphan@GRAD"}, {"Out": "s"})
    return prog, {}


def _registry_contract(P):
    prog = P.Program()
    blk = prog.global_block()
    for n in ("W", "Ids", "Out@GRAD", "W@GRAD", "Ids@GRAD", "Mask",
              "X", "Out", "X@GRAD"):
        blk.create_var(n, is_data=True)
    # c_embedding (a waiting op in the port) keeps its no_grad_slots
    blk.append_op(
        "c_embedding_grad",
        {"W": ["W"], "Ids": ["Ids"], "Out@GRAD": ["Out@GRAD"]},
        {"W@GRAD": ["W@GRAD"], "Ids@GRAD": ["Ids@GRAD"]})
    blk.append_op("dropout_grad", {"Out@GRAD": ["Out@GRAD"]},
                  {"X@GRAD": ["X@GRAD"]})
    return prog, {"checks": ["gradient.registry-contract"]}


def _clean(P):
    prog = P.Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 2.0})
    return prog, {"fetches": ["y"]}


def _communication_ops(P):
    prog = P.Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True, shape=[4, 8], dtype="float32")
    blk.create_var("ids", is_data=True, shape=[4], dtype="int64")
    blk.create_var("y")
    blk.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 2.0})
    cases = [
        ("barrier", {"X": "x"}, {"Out": "b_out"}, {}),
        ("allreduce", {"X": "x"}, {"Out": "ar_out"}, {}),
        ("partial_allgather", {"X": "x"}, {"Out": "pg_out"}, {}),
        ("distributed_lookup_table", {"Ids": "ids"}, {"Out": "dl_out"},
         {"table_name": "t", "value_dim": 8}),
        ("distributed_lookup_table_grad",
         {"Ids": "ids", "Out@GRAD": "y"}, {"W@GRAD": "push_token"},
         {"table_name": "t", "value_dim": 8}),
    ]
    for op_type, ins, outs, attrs in cases:
        for names in outs.values():
            blk.create_var(names)
        blk.append_op(op_type, ins, outs, attrs)
    return prog, {"fetches": ["y"]}


BUILDERS = {
    "undefined_input_var": _undefined_input_var,
    "unregistered_op_type": _unregistered_op_type,
    "derived_grad_op": _derived_grad_op,
    "dangling_sub_block": _dangling_sub_block,
    "cyclic_sub_blocks": _cyclic_sub_blocks,
    "bad_slot_and_dtype": _bad_slot_and_dtype,
    "write_after_write": _write_after_write,
    "dead_op_unfetched": _dead_op,
    "dead_op_fetched": lambda P: (_dead_op(P)[0], {"fetches": ["y"]}),
    "grad_pairing": _grad_pairing,
    "registry_contract": _registry_contract,
    "clean": _clean,
    "communication_ops": _communication_ops,
}


def _both(name):
    jprog, kw = BUILDERS[name](JAX)
    tprog, _ = BUILDERS[name](PORT)
    return JAX.verify(jprog, **kw), PORT.verify(tprog, **kw)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_diagnostics_match_jax(name):
    jres, tres = _both(name)
    assert _key(tres) == _key(jres)
    assert tres.ok() == jres.ok()


def test_reference_assertions_hold_on_the_port():
    """``tests/test_program_verifier.py``'s own findings, on the port."""
    r = _both("undefined_input_var")[1]
    (d,) = _find(r, "dataflow.def-before-use", "error")
    assert (d.block_idx, d.op_idx, d.var) == (0, 1, "ghost")
    (d,) = _find(_both("unregistered_op_type")[1],
                 "structural.registered-ops", "error")
    assert (d.block_idx, d.op_idx) == (0, 1)
    assert not _find(_both("derived_grad_op")[1], "structural.registered-ops")
    assert any((d.block_idx, d.op_idx) == (0, 0) and "7" in d.message
               for d in _find(_both("dangling_sub_block")[1],
                              "structural.sub-blocks", "error"))
    assert any("cyclic" in d.message
               for d in _find(_both("cyclic_sub_blocks")[1],
                              "structural.sub-blocks", "error"))
    r = _both("bad_slot_and_dtype")[1]
    (d,) = _find(r, "structural.slot-shape", "error")
    assert (d.block_idx, d.op_idx) == (0, 0)
    (d,) = _find(r, "structural.dtypes", "error")
    assert d.var == "w"
    r = _both("write_after_write")[1]
    (d,) = _find(r, "dataflow.write-after-write", "warning")
    assert (d.block_idx, d.op_idx, d.var) == (0, 1, "y") and not r.errors
    assert not _find(_both("dead_op_unfetched")[1], "dataflow.dead-code")
    r = _both("dead_op_fetched")[1]
    assert [(d.block_idx, d.op_idx) for d in _find(r, "dataflow.dead-code")
            if d.op_idx is not None] == [(0, 1)] and not r.errors
    (d,) = _find(_both("grad_pairing")[1], "gradient.grad-pairing", "error")
    assert (d.block_idx, d.op_idx, d.var) == (0, 0, "orphan@GRAD")
    r = _both("registry_contract")[1]
    (err,) = r.errors
    assert (err.op_idx, err.var) == (0, "Ids@GRAD")
    assert "no_grad_slots" in err.message
    (warn,) = r.warnings
    assert warn.op_idx == 1 and "Mask" in warn.message
    r = _both("clean")[1]
    assert r.ok() and not r.diagnostics
    assert "program verifies clean" in r.summary()
    assert not _find(_both("communication_ops")[1], "dataflow.dead-code")


def test_check_registry_and_unknown_check_name():
    assert list(ANALYSIS_CHECKS) == list(JCHECKS)
    with pytest.raises(ValueError, match="no-such-check"):
        verify_program(Program(), checks=["no-such-check"])


def test_registry_side_effect_field_drives_dead_code():
    """The collectives keep the reference's ``side_effect`` field, and a
    derived ``<fw>_grad`` inherits it."""
    from paddle_tpu_torch.ops import registry as treg
    assert treg.declared("c_allgather").side_effect
    op_like = types.SimpleNamespace(type="c_allgather", outputs={"Out": ["g"]})
    assert tfa._has_side_effects(op_like)
    op_like.type = "c_allgather_grad"
    assert tfa._has_side_effects(op_like)
    assert tfa.SIDE_EFFECT_OP_TYPES == paddle_tpu.framework.analysis \
        .SIDE_EFFECT_OP_TYPES
    # lowered at one rank (A5a): the gather of one rank is its input;
    # an axis bound over more ranks waits for A5b
    x = torch.arange(2.0)
    (out,) = treg.execute(treg.LoweringContext(device="cpu"), "c_allgather",
                          {"X": [x]}, {})["Out"]
    assert torch.equal(out, x)
    wide = treg.LoweringContext(device="cpu", axis_env={0: "dp"},
                                mesh=types.SimpleNamespace(shape={"dp": 2}))
    with pytest.raises(NotImplementedError, match="A5b"):
        treg.execute(wide, "c_allgather", {"X": [x]}, {})


# ---------------------------------------------------------------------
# the executor (FLAGS_check_program) and the pass manager
# (FLAGS_check_ir_passes)
# ---------------------------------------------------------------------


def test_executor_rejects_broken_program_at_first_run():
    prog = Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("elementwise_add", {"X": "x", "Y": "ghost"},
                  {"Out": "y"})
    saved = tflags.get_flags(["check_program"])
    try:
        tflags.set_flags({"check_program": True})
        with pytest.raises(ProgramVerifyError) as ei:
            Executor("cpu").run(prog, feed={"x": np.ones((2,), np.float32)},
                                fetch_list=["y"], scope=Scope())
    finally:
        tflags.set_flags(saved)
    assert "ghost" in str(ei.value)
    assert "FLAGS_check_program" in str(ei.value)
    assert [d.var for d in ei.value.result.errors] == ["ghost"]


def test_executor_verify_honors_scope_state():
    prog = Program()
    blk = prog.global_block()
    blk.create_var("w", persistable=True)
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("elementwise_add", {"X": "x", "Y": "w"}, {"Out": "y"})
    scope = Scope()
    scope.set_var("w", np.full((2,), 3.0, np.float32))
    saved = tflags.get_flags(["check_program"])
    try:
        tflags.set_flags({"check_program": True})
        (out,) = Executor("cpu").run(
            prog, feed={"x": np.ones((2,), np.float32)}, fetch_list=["y"],
            scope=scope)
    finally:
        tflags.set_flags(saved)
    np.testing.assert_allclose(out, 4.0)


@ir.register_pass("_torch_test_drop_producer_pass")
def _drop_producer(graph):
    del graph._program.global_block().ops[0]


@jir.register_pass("_torch_test_drop_producer_pass")
def _jdrop_producer(graph):
    del graph._program.global_block().ops[0]


def _two_op_program(P):
    prog = P.Program()
    blk = prog.global_block()
    blk.create_var("x", is_data=True)
    blk.create_var("y")
    blk.append_op("scale", {"X": "x"}, {"Out": "y"}, {"scale": 2.0})
    blk.create_var("z")
    blk.append_op("scale", {"X": "y"}, {"Out": "z"}, {"scale": 3.0})
    return prog


def _pm_error(pm_mod, flags_mod, prog, passes):
    saved = flags_mod.get_flags(["check_ir_passes"])
    try:
        flags_mod.set_flags({"check_ir_passes": True})
        with pytest.raises(Exception) as ei:
            pm_mod.PassManager(passes).apply(prog)
    finally:
        flags_mod.set_flags(saved)
    return ei.value


def test_broken_ir_pass_is_named_as_the_reference_names_it():
    prog = _two_op_program(PORT)
    pm = ir.PassManager(["_torch_test_drop_producer_pass"])
    saved = tflags.get_flags(["check_ir_passes"])
    try:
        tflags.set_flags({"check_ir_passes": False})
        pm.apply(prog)  # unchecked: the corruption passes through
    finally:
        tflags.set_flags(saved)
    e = _pm_error(ir, tflags, prog, ["_torch_test_drop_producer_pass"])
    je = _pm_error(jir, jflags, _two_op_program(JAX),
                   ["_torch_test_drop_producer_pass"])
    assert isinstance(e, ProgramVerifyError)
    assert "_torch_test_drop_producer_pass" in str(e)
    assert "def-before-use" in str(e)
    assert all(d.pass_name == "_torch_test_drop_producer_pass"
               for d in e.result.diagnostics)
    assert _key(e.result) == _key(je.result)


def test_pre_broken_program_not_blamed_on_first_pass():
    def build(P):
        prog = P.Program()
        blk = prog.global_block()
        blk.create_var("y")
        blk.append_op("scale", {"X": "nowhere"}, {"Out": "y"})
        return prog

    e = _pm_error(ir, tflags, build(PORT), ["fuse_elewise_add_act_pass"])
    je = _pm_error(jir, jflags, build(JAX), ["fuse_elewise_add_act_pass"])
    assert isinstance(e, ProgramVerifyError)
    assert "already invalid before the first pass" in str(e)
    assert "fuse_elewise_add_act_pass" not in str(e)
    assert _key(e.result) == _key(je.result)


def test_real_pass_pipeline_stays_clean_under_check():
    saved = tflags.get_flags(["check_ir_passes"])
    try:
        tflags.set_flags({"check_ir_passes": True})
        out = ir.PassManager(["fuse_elewise_add_act_pass",
                              "delete_dropout_op_pass"]).apply(
            _two_op_program(PORT))
    finally:
        tflags.set_flags(saved)
    assert verify_program(out).ok()


# ---------------------------------------------------------------------
# the eight Book programs
# ---------------------------------------------------------------------


@pytest.mark.parametrize("name", list(book.PROGRAMS))
def test_book_programs_verify_like_the_reference(name):
    jb = book.PROGRAMS[name](paddle_tpu)
    tb = book.PROGRAMS[name](paddle_tpu_torch)
    fetches = [v.name for v in tb.fetches]
    jres = jb.main.verify(fetches=fetches)
    tres = tb.main.verify(fetches=fetches)
    assert _key(tres) == _key(jres)
    assert tres.ok() and not tres.warnings, tres.summary()
    jsres, tsres = jb.startup.verify(), tb.startup.verify()
    assert _key(tsres) == _key(jsres)
    assert tsres.ok(), tsres.summary()
    for d in tsres.warnings:
        assert d.check == "dataflow.write-after-write", str(d)


def test_pipeline_backward_programs_verify_where_the_reference_rejects():
    """Pinned divergence (ROADMAP C): the reference's pipeline split
    leaves out of a stage's backward program the forward vars of the
    grads it computes when no op there reads them and the scope does not
    carry them, and its own verifier then rejects the program, with the
    scope's values as feeds as its executor verifies it
    (``gradient.grad-pairing``, so a pipelined encoder fails under
    FLAGS_check_program there); the port's split declares them, so the
    same ops verify clean."""
    import types as _t

    from paddle_tpu import layers as JL
    from paddle_tpu import optimizer as JO
    from paddle_tpu.framework import device_guard as jdg
    from paddle_tpu.framework import program_guard as jguard
    from paddle_tpu.framework import unique_name as jun
    from paddle_tpu_torch import optimizer as TO
    from paddle_tpu_torch.models.static_encoder import build_encoder_program
    jst = _t.SimpleNamespace(layers=JL, Program=JProgram, program_guard=jguard,
                             unique_name=jun, AdamW=JO.AdamW,
                             device_guard=jdg)
    stages = {}
    for name, st, O in (("jax", jst, JO), ("port", None, TO)):
        def pipe(loss, rate, ckpts, O=O):
            O.PipelineOptimizer(O.AdamW(learning_rate=rate),
                                num_microbatches=2).minimize(loss)

        main, _, _ = build_encoder_program(2, 128, 2, 256, 64, minimize=pipe,
                                           split_after=1, static=st)
        stages[name] = main._pipeline_stages
    def carried(name):
        # the scope carries every stage program's persistable values
        return {"x"} | {v.name for st in stages[name]
                        for _, prog in st.phases()
                        for v in prog.global_block().vars.values()
                        if v.persistable}

    for js, ts in zip(stages["jax"], stages["port"]):
        for (phase, jp), (_, tp) in zip(js.phases(), ts.phases()):
            assert [op.type for op in tp.global_block().ops] == \
                [op.type for op in jp.global_block().ops]
            jres = JAX.verify(jp, feeds=carried("jax"))
            tres = verify_program(tp, feeds=carried("port"))
            assert tres.ok(), tres.summary()
            if phase == "backward":
                assert jres.errors and {d.check for d in jres.errors} == {
                    "gradient.grad-pairing"}
            else:
                assert jres.ok()
