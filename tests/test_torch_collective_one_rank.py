"""The collectives and ``dpsgd`` at one rank (ROADMAP A5a) against the
JAX package on the CPU: every case of ``torch_op_cases_collective.py``
(each op's lowering and its grad ops, as ``test_torch_static.py`` holds
``OP_CASES``, JAX with no mesh axis bound: its single-trainer branch),
an axis bound over more than one rank raising (A5b), and the eager
collectives of ``distributed/collective.py`` over the tape, with the
reference's fault site and retry.

Tolerance: 2e-5 relative plus 2e-6 absolute unless a case names its
own; ``dpsgd``'s noise comes from ``prng.normal``, within a few float32
ulps of ``jax.random.normal`` (ROADMAP C, "Random streams").
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import types
import zlib

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.distributed.collective as jcoll
import paddle_tpu.dygraph as JD
from paddle_tpu import monitor as jmonitor
from paddle_tpu.resilience.injector import fault_scope as jfault_scope

import paddle_tpu_torch.distributed as tdist
import paddle_tpu_torch.dygraph as TD
from paddle_tpu_torch import monitor as tmonitor
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.ops import registry as treg
from paddle_tpu_torch.resilience.injector import fault_scope as tfault_scope
from test_torch_static import _close, _run
from torch_op_cases_collective import ONE_RANK_CASES, ONE_RANK_X32


@pytest.mark.parametrize("case", sorted(ONE_RANK_CASES))
def test_one_rank_op_matches_the_jax_lowering(case):
    op_type, make, attrs, tol = ONE_RANK_CASES[case]
    tol = tol or (2e-6, 2e-5)
    ins = make(np.random.RandomState(zlib.crc32(case.encode())))
    touts, _ = _run("port", op_type, ins, attrs, None)
    crng = np.random.RandomState(7)
    d = treg.get_op_def(op_type)
    cots = {f"{s}:{i}@G": np.asarray(crng.randn(*v.shape), v.dtype)
            for s, vals in touts.items() for i, v in enumerate(vals)
            if v.dtype.kind == "f" and s not in d.nondiff_outputs}
    with jax.enable_x64(case not in ONE_RANK_X32):
        jouts, jgrads = _run("jax", op_type, ins, attrs, cots)
    touts, tgrads = _run("port", op_type, ins, attrs, cots)
    assert set(touts) == set(jouts)
    for s in jouts:
        for a, b in zip(touts[s], jouts[s]):
            _close(a, b, tol)
    assert set(tgrads) == set(jgrads)
    for n in jgrads:
        _close(tgrads[n], jgrads[n], tol)


@pytest.mark.parametrize("op_type", sorted({c[0] for c in
                                            ONE_RANK_CASES.values()}
                                           - {"dpsgd"}))
def test_an_axis_of_more_than_one_rank_waits_for_a5b(op_type):
    ins = ONE_RANK_CASES[op_type][1](np.random.RandomState(0))
    ins = {s: [torch.tensor(a) for a in v] for s, v in ins.items()}
    wide = treg.LoweringContext(device="cpu", axis_env={0: "dp"},
                                mesh=types.SimpleNamespace(shape={"dp": 2}))
    with pytest.raises(NotImplementedError, match="A5b"):
        treg.execute(wide, op_type, ins, {"ring_id": 0})
    # the ring registered on a mesh of one rank is the identity
    one = treg.LoweringContext(device="cpu", axis_env={0: "dp"},
                               mesh=types.SimpleNamespace(shape={"dp": 1}))
    treg.execute(one, op_type, ins, {"ring_id": 0})


X = np.random.RandomState(3).randn(4, 3).astype(np.float32)

EAGER = {
    "all_reduce": lambda C, t: C.all_reduce(t, C.ReduceOp.MAX),
    "broadcast": lambda C, t: C.broadcast(t, 0),
    "all_gather": lambda C, t: C.all_gather([], t),
    "reduce": lambda C, t: C.reduce(t, 0),
    "reduce_scatter": lambda C, t: C.reduce_scatter(t),
    "scatter": lambda C, t: C.scatter(t, [t, t]),
    "split": lambda C, t: C.split(t),
}


@pytest.mark.parametrize("name", sorted(EAGER))
def test_eager_collective_at_one_rank_matches_the_reference(name):
    def run(C, D, kw):
        t = D.to_tensor(X, stop_gradient=False, **kw)
        out = EAGER[name](C, t)
        (g,) = D.grad((out * out).sum(), [t])
        return np.asarray(out.numpy()), np.asarray(g.numpy()), \
            np.asarray(t.numpy())
    j = run(jcoll, JD, {})
    t = run(tdist, TD, {"device": "cpu"})
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert tdist.barrier() is None and jcoll.barrier() is None


def test_all_reduce_keeps_the_fault_site_and_retries_a_drop():
    for D, C, scope, mon, kw in ((JD, jcoll, jfault_scope, jmonitor, {}),
                                 (TD, tdist, tfault_scope, tmonitor,
                                  {"device": "cpu"})):
        t = D.to_tensor(np.ones(4, np.float32), **kw)
        before = (mon.stat_get("STAT_fault_collective.allreduce"),
                  mon.stat_get("STAT_retry_collective.allreduce"))
        with scope("collective.allreduce:drop@0"):
            out = C.all_reduce(t)
        np.testing.assert_allclose(np.asarray(out.numpy()), 1.0)
        assert mon.stat_get("STAT_fault_collective.allreduce") == \
            before[0] + 1
        assert mon.stat_get("STAT_retry_collective.allreduce") == \
            before[1] + 1


def test_eager_collective_over_a_wider_mesh_raises():
    saved = tenv.current_mesh()
    tenv.register_ring(0, "dp")
    tenv.set_mesh(types.SimpleNamespace(shape={"dp": 2}))
    try:
        with pytest.raises(NotImplementedError, match="A5b"):
            tdist.all_reduce(TD.to_tensor(X, device="cpu"))
    finally:
        tenv.set_mesh(saved)
        tenv._ring_to_axis.pop(0, None)
