"""The image, detection and quantization half of the port's op library
against the JAX package's lowerings on the CPU: every case of
``torch_op_cases_tail.TAIL_CASES``, its outputs and its generic,
registered or straight-through grad, on the same seeded inputs.

The counterparts of ``tests/test_ops_tail_image.py``,
``test_ops_tail_misc.py`` and ``test_ops_tail_structured.py`` are these
cases. Tolerances: f32 results within ``2e-6 + 2e-5 |ref|`` (the two
sides differ in the order of sums), convolutions, contractions and
normalizations within ``1e-5 + 1e-4 |ref|``; integer results, the NMS
rows' labels and counts, the host ops' samples and the random streams
(``sampling_id``, ``random_crop``, ``nce``, ``sample_logits``, compared
with JAX's 64-bit types off, the streams the port reproduces) bit for
bit.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import types
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops  # noqa: F401  (registers every lowering)
from paddle_tpu.ops import registry as jreg

from paddle_tpu_torch import prng
from paddle_tpu_torch.ops import registry as treg
from torch_op_cases_tail import TAIL_CASES, TAIL_JIT, TAIL_RAISES, TAIL_X32


def _close(out, ref, tol=(2e-6, 2e-5)):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    if ref.dtype.kind in "biu":
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out.astype(np.float64),
                                   ref.astype(np.float64), atol=tol[0],
                                   rtol=tol[1])


def _grad_desc(reg, op_type, ins, outs):
    d = reg.get_op_def(op_type)
    fw = types.SimpleNamespace(
        type=op_type, attrs={},
        inputs={s: [f"{s}:{i}" for i in range(len(v))] for s, v in
                ins.items()},
        outputs={s: [f"{s}:{i}" for i in range(len(v))] for s, v in
                 outs.items()})
    out_g = {s: [f"{s}:{i}@G" if np.asarray(v).dtype.kind == "f" and
                 s not in d.nondiff_outputs else None
                 for i, v in enumerate(vals)] for s, vals in outs.items()}
    wanted = {s: [f"{s}:{i}@IG" if np.asarray(v).dtype.kind == "f" else None
                  for i, v in enumerate(vals)] for s, vals in ins.items()}
    return fw, out_g, wanted


def run_case(pkg, op_type, ins_np, attrs, cots, jitted=False):
    """Forward outputs and input gradients (numpy) of ``op_type`` in one
    package ("jax" or "port"); ``jitted`` compiles the JAX side."""
    if pkg == "jax":
        reg, conv = jreg, jnp.asarray
        ctx = jreg.LoweringContext(rng=jax.random.PRNGKey(5))
    else:
        reg, conv = treg, (lambda a: torch.tensor(np.asarray(a)))
        ctx = treg.LoweringContext(rng=prng.PRNGKey(5), device="cpu")
    ins = {s: [conv(a) for a in v] for s, v in ins_np.items()}
    execute = reg.execute
    if pkg == "jax" and jitted:
        # as the reference's executor compiles an op: its attrs are
        # constants of the compiled function
        def execute(c, t, i, a):
            return jax.jit(lambda v: jreg.execute(c, t, v, a))(i)
    outs = execute(ctx, op_type, ins, dict(attrs))
    outs_np = {s: [np.array(v) for v in vals] for s, vals in outs.items()}
    d = reg.get_op_def(op_type)
    if d.not_differentiable or cots is None:
        return outs_np, {}
    fw, out_g, wanted = _grad_desc(reg, op_type, ins_np, outs_np)
    fw.attrs = dict(attrs)
    env = {f"{s}:{i}": v for s, vals in ins.items()
           for i, v in enumerate(vals)}
    env.update({f"{s}:{i}": v for s, vals in outs.items()
                for i, v in enumerate(vals)})
    env.update({k: conv(v) for k, v in cots.items()})
    grads = {}
    for g_type, g_in, g_out, g_attrs in reg.make_grad_ops(fw, out_g,
                                                          wanted):
        res = execute(ctx, g_type, {s: [env[n] for n in names]
                                    for s, names in g_in.items()}, g_attrs)
        for s, names in g_out.items():
            for n, v in zip(names, res[s]):
                grads[n] = np.array(v)
    return outs_np, grads


def case_inputs(case):
    op_type, make, attrs, tol = TAIL_CASES[case]
    rng = np.random.RandomState(zlib.crc32(case.encode()))
    return op_type, make(rng), attrs, tol or (2e-6, 2e-5)


@pytest.mark.parametrize("case", sorted(TAIL_CASES))
def test_op_matches_the_jax_lowering(case):
    op_type, ins, attrs, tol = case_inputs(case)
    x32 = case in TAIL_X32
    if case in TAIL_RAISES:
        with pytest.raises(TAIL_RAISES[case]):
            run_case("jax", op_type, ins, attrs, None)
        with pytest.raises(TAIL_RAISES[case]):
            run_case("port", op_type, ins, attrs, None)
        return
    touts, _ = run_case("port", op_type, ins, attrs, None)
    crng = np.random.RandomState(7)
    cots = {f"{s}:{i}@G": np.asarray(crng.randn(*v.shape), v.dtype)
            for s, vals in touts.items() for i, v in enumerate(vals)
            if v.dtype.kind == "f"}
    with jax.enable_x64(not x32):
        jouts, jgrads = run_case("jax", op_type, ins, attrs, cots,
                                 x32 or case in TAIL_JIT)
    touts, tgrads = run_case("port", op_type, ins, attrs, cots)
    assert set(touts) == set(jouts)
    for s in jouts:
        assert len(touts[s]) == len(jouts[s]), s
        for a, b in zip(touts[s], jouts[s]):
            _close(a, b, tol)
    assert set(tgrads) == set(jgrads)
    for n in jgrads:
        _close(tgrads[n], jgrads[n], tol)


def test_straight_through_gradient_is_the_identity():
    """Every fake-quant op's X gradient is the incoming gradient itself,
    through ``ste_identity_grad`` (the rounding's zero derivative would
    stop training)."""
    quant = [c for c in TAIL_CASES if c.startswith(("fake_quantize_",
                                                    "fake_channel_wise_q",
                                                    "moving_average"))]
    assert len(quant) >= 8
    for case in quant:
        op_type, ins, attrs, _ = case_inputs(case)
        d = treg.get_op_def(op_type)
        assert d.custom_grad_maker is not None, op_type
        cot = np.random.RandomState(1).randn(
            *ins["X"][0].shape).astype(np.float32)
        _, grads = run_case("port", op_type, ins, attrs, {"Out:0@G": cot})
        np.testing.assert_array_equal(grads["X:0@IG"], cot)


def test_nms_ties_at_the_kth_score_enter_together():
    """Four boxes share the 4th-best score of each class; a k of 5
    admits all of them (the reference's ``scores >= kth``), so more than
    k candidates of one class survive the truncation."""
    op_type, ins, attrs, _ = case_inputs("multiclass_nms:kth_tie")
    attrs = dict(attrs, nms_threshold=1.0, keep_top_k=30)  # no suppression
    outs, _ = run_case("port", op_type, ins, attrs, None)
    # per class: three above the tie, four at the k-th score
    np.testing.assert_array_equal(outs["NumDetected"][0], [21, 21])
    with jax.enable_x64(True):
        jouts, _ = run_case("jax", op_type, ins, attrs, None, True)
    np.testing.assert_array_equal(jouts["NumDetected"][0], [21, 21])
    np.testing.assert_allclose(outs["Out"][0], jouts["Out"][0], rtol=1e-6)


def test_nms_drops_ties_beyond_the_slack():
    """The port's one divergence from the reference's NMS (ROADMAP C):
    it admits at most ``nms_top_k + NMS_TIE_SLACK`` candidates of a
    class, so where more than 64 boxes tie at the k-th score it drops
    the surplus (the last of them in index order). One class, k = 5,
    100 boxes sharing the 5th-best score, none overlapping: the
    reference keeps all 104, the port the first 69 of them, row for
    row."""
    from paddle_tpu_torch.ops.detection_ops import NMS_TIE_SLACK
    m, k, tied = 200, 5, 100
    xy = np.stack([np.arange(m) * 3.0, np.zeros(m)], 1)
    boxes = np.concatenate([xy, xy + 1.0], 1).astype(np.float32)[None]
    scores = np.random.RandomState(4).rand(1, 1, m).astype(np.float32) * .4
    scores[0, 0, 10:14] = [0.9, 0.8, 0.7, 0.6]
    scores[0, 0, 50:50 + tied] = 0.5
    attrs = {"background_label": -1, "score_threshold": 0.0,
             "nms_threshold": 0.3, "nms_top_k": k, "keep_top_k": m,
             "normalized": False}
    ins = {"BBoxes": [boxes], "Scores": [scores]}
    outs, _ = run_case("port", "multiclass_nms", ins, attrs, None)
    with jax.enable_x64(True):
        jouts, _ = run_case("jax", "multiclass_nms", ins, attrs, None, True)
    n = k + NMS_TIE_SLACK
    assert int(outs["NumDetected"][0][0]) == n == 69
    assert int(jouts["NumDetected"][0][0]) == k - 1 + tied == 104
    np.testing.assert_allclose(outs["Out"][0][0, :n], jouts["Out"][0][0, :n],
                               rtol=1e-6)
    # the surplus ties, boxes 115..149, are the reference's alone
    np.testing.assert_array_equal(jouts["Out"][0][0, n:104, 2] / 3.0,
                                  np.arange(50 + n - 4, 50 + tied))
    assert (outs["Out"][0][0, n:, 0] == -1).all()
