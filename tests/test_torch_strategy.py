"""The port's static rewrites of a Program against the JAX package's on
the CPU: the bf16 AMP rewrite (``amp/static_amp.py``), the recompute
backward and ``RecomputeOptimizer``, gradient merge, the LAMB/LARS swap
and the fleet's strategy chain (``distributed/fleet/fleet_base.py``) at
one rank, and the parts that wait for other ROADMAP items.

Both packages build each program under ``unique_name.guard()``; the
rewritten programs serialize to the same JSON (op types in order, their
inputs and outputs, the cast names, the dtypes stamped on the white-list
outputs). The JAX fleet is pinned to one rank: the suite forces 8 host
devices, so its ``fleet.init`` would build an 8-way mesh and insert
``c_allreduce_sum``; each test sets a one-device mesh through
``paddle_tpu.distributed.env`` after ``init`` and puts both packages'
environment back afterwards.

Tolerances: f32 programs' losses within 1e-5 relative and parameters
within ``1e-6 + 1e-5 |ref|``. Under AMP both sides round the same
products to bf16 but accumulate them in another order, so a product's
bf16 rounding may differ by one ulp: losses stay within 1e-5 relative,
and AdamW parameters are held to ``2 k lr + 1e-6`` per element after k
steps (an Adam step is near ``lr x sign(g)``, and the key projection's
bias has a zero true gradient whose sign is rounding on either side).
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import types

import jax
import numpy as np
import pytest

import paddle_tpu.flags as jflags
import paddle_tpu.layers as JL
import paddle_tpu.optimizer as JO
from paddle_tpu.amp import static_amp as jamp
from paddle_tpu.amp.lists import AutoMixedPrecisionLists as JLists
from paddle_tpu.distributed import env as jenv
from paddle_tpu.distributed.fleet.distributed_strategy import \
    DistributedStrategy as JStrategy
from paddle_tpu.distributed.fleet.fleet_base import Fleet as JFleet
from paddle_tpu.framework import Executor as JExecutor
from paddle_tpu.framework import Program as JProgram
from paddle_tpu.framework import Scope as JScope
from paddle_tpu.framework import append_backward as jbackward
from paddle_tpu.framework import device_guard as jdevice_guard
from paddle_tpu.framework import program_guard as jguard
from paddle_tpu.framework import unique_name as jun

import paddle_tpu_torch.layers as TL
import paddle_tpu_torch.optimizer as TO
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.amp import static_amp as tamp
from paddle_tpu_torch.amp.lists import AutoMixedPrecisionLists as TLists
from paddle_tpu_torch.distributed import env as tenv
from paddle_tpu_torch.distributed import fleet as tfleet_mod
from paddle_tpu_torch.distributed import parallel as tparallel
from paddle_tpu_torch.distributed.fleet import fleet_base as tfb
from paddle_tpu_torch.distributed.fleet.distributed_strategy import \
    DistributedStrategy as TStrategy
from paddle_tpu_torch.distributed.fleet.fleet_base import Fleet as TFleet
from paddle_tpu_torch.framework import (Executor, Program, Scope,
                                        append_backward, program_guard,
                                        unique_name)
from paddle_tpu_torch.models.convert import scope_from_numpy
from paddle_tpu_torch.models.static_encoder import build_encoder_program

JSTATIC = types.SimpleNamespace(layers=JL, Program=JProgram,
                                program_guard=jguard, unique_name=jun,
                                AdamW=JO.AdamW, device_guard=jdevice_guard)
ENC = dict(num_layers=1, d_model=64, num_heads=2, d_ffn=128, seq=64)
LR = 1e-4

JAX = types.SimpleNamespace(
    L=JL, O=JO, Program=JProgram, Scope=JScope, guard=jguard, un=jun,
    backward=jbackward, Fleet=JFleet, Strategy=JStrategy, amp=jamp,
    exe=lambda: JExecutor())
PORT = types.SimpleNamespace(
    L=TL, O=TO, Program=Program, Scope=Scope, guard=program_guard,
    un=unique_name, backward=append_backward, Fleet=TFleet,
    Strategy=TStrategy, amp=tamp, exe=lambda: Executor("cpu"))


@pytest.fixture(autouse=True)
def _env():
    """Both packages' flags and distributed environment put back."""
    saved = tflags.get_flags(["pallas_min_seq"])
    jsaved = jflags.get_flags(["pallas_min_seq"])
    envs = [(m, m._mesh, m._data_axis, dict(m._ring_to_axis))
            for m in (jenv, tenv)]
    yield
    tflags.set_flags(saved)
    jflags.set_flags(jsaved)
    for m, mesh, axis, rings in envs:
        m._mesh, m._data_axis = mesh, axis
        m._ring_to_axis.clear()
        m._ring_to_axis.update(rings)


def _init(pkg, strategy=None):
    f = pkg.Fleet()
    f.init(is_collective=True, strategy=strategy)
    if pkg is JAX:
        jenv.set_mesh(jenv.build_mesh(("dp",), devices=jax.devices()[:1]))
    return f


def _mlp(pkg, seed=3, minimize=None):
    """``tests/test_strategy_rewrites.py``'s MLP; ``minimize(loss,
    checkpoints)`` runs inside the same name guard, so both packages
    name the optimizer's variables alike."""
    L = pkg.L
    main, startup = pkg.Program(), pkg.Program()
    main.random_seed = startup.random_seed = seed
    with pkg.guard(main, startup), pkg.un.guard():
        x = L.data("x", [8])
        y = L.data("y", [1], dtype="int64")
        h1 = L.fc(x, 16, act="relu")
        h2 = L.fc(h1, 16, act="relu")
        logits = L.fc(h2, 4)
        loss = L.mean(L.softmax_with_cross_entropy(logits, y))
        if minimize is not None:
            minimize(loss, (h1, h2))
    return main, startup, loss, (h1, h2)


def _batch(bs=32, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(bs, 8).astype(np.float32),
            "y": rng.randint(0, 4, (bs, 1)).astype(np.int64)}


def _start(jstartup, tstartup=None):
    """The JAX startup's scope and the port's copy of it."""
    jscope, jexe = JScope(), JExecutor()
    jexe.run(jstartup, scope=jscope)
    tscope = scope_from_numpy({n: jscope.get_numpy(n)
                               for n in jscope.var_names()}, "cpu")
    return jscope, jexe, tscope, Executor("cpu")


def _steps(jm, tm, jl, tl, feeds, jscope, jexe, tscope, texe):
    out = []
    for feed in feeds:
        (a,) = jexe.run(jm, feed=feed, fetch_list=[jl], scope=jscope)
        (b,) = texe.run(tm, feed=feed, fetch_list=[tl], scope=tscope)
        out.append((float(np.mean(a)), float(np.mean(b))))
    return out


def _params_close(jscope, tscope, names, tol=(1e-6, 1e-5)):
    for n in names:
        np.testing.assert_allclose(tscope.get_numpy(n), jscope.get_numpy(n),
                                   atol=tol[0], rtol=tol[1], err_msg=n)


def _amp_min(pkg, **kw):
    def minimize(loss, rate, checkpoints):
        pkg.amp.rewrite_program(loss.block.program)
        pkg.O.AdamW(learning_rate=rate, weight_decay=0.01).minimize(loss)
    return minimize


# ------------------------------------------------------------------- AMP
def test_amp_lists_follow_the_reference():
    for w, b in ((None, None), (["softmax"], None), (None, ["mul"]),
                 (["layer_norm"], ["conv2d"])):
        j, t = JLists(w, b), TLists(w, b)
        assert (t.white_list, t.black_list) == (j.white_list, j.black_list)


def test_amp_rewrite_and_its_steps_match_the_reference():
    """The encoder rewritten to bf16 (flash and LayerNorm routes on):
    the same casts, cast names and stamped dtypes as the reference, op
    for op; two AdamW steps from one startup."""
    for flags in (jflags, tflags):
        flags.set_flags({"pallas_min_seq": 64})
    jm, js, jl = build_encoder_program(**ENC, lr=LR, static=JSTATIC,
                                       minimize=_amp_min(JAX))
    tm, ts, tl = build_encoder_program(**ENC, lr=LR, minimize=_amp_min(PORT))
    assert tm.to_json() == jm.to_json()
    types_ = [op.type for op in tm.global_block().ops]
    fwd = tm.global_block().ops[:types_.index("fill_constant_like")]
    casts = [op for op in fwd if op.type == "cast"]
    # each fc's input and weight, and q/k/v of each attention, cast to
    # bf16; a layer_norm reads a bias add's f32 output (a bf16 product
    # plus an f32 bias promotes to f32), so no cast back is needed
    assert {op.attrs["out_dtype"] for op in casts} == {"bfloat16"}
    for op in fwd:
        if op.type in ("mul", "fused_attention_qkv"):
            assert all(tm.global_block().var(n).dtype == "bfloat16"
                       for n in op.input_names() + op.output_names()), op.type
        if op.type == "layer_norm":
            assert tm.global_block().var(op.input("X")[0]).dtype == "float32"
    jscope, jexe, tscope, texe = _start(js)
    x = np.random.RandomState(1).randn(2, ENC["seq"], ENC["d_model"]) \
        .astype(np.float32)
    losses = _steps(jm, tm, jl.name, tl.name, [{"x": x}] * 2, jscope, jexe,
                    tscope, texe)
    for a, b in losses:
        assert abs(b - a) <= 1e-5 * abs(a), losses
    for p in jm.all_parameters():
        err = np.abs(tscope.get_numpy(p.name) - jscope.get_numpy(p.name))
        assert err.max() <= 2 * 2 * LR + 1e-6, (p.name, err.max())


def test_decorate_rewrites_before_minimize_like_the_reference():
    progs = {}
    for pkg in (JAX, PORT):
        main, _, _, _ = _mlp(pkg, minimize=lambda loss, ck, pkg=pkg:
                             pkg.amp.decorate(pkg.O.SGD(0.1)).minimize(loss))
        progs[pkg is PORT] = main.to_json()
    assert progs[True] == progs[False]


# ------------------------------------------------------------- recompute
def test_recompute_program_shape_and_gradients():
    """The checkpointed backward: the reference's op list, its
    gradients, and the port's plain backward's gradients bit for bit."""
    feed = _batch()
    grads = {}
    for ck in (False, True):
        built = {}
        for pkg in (JAX, PORT):
            main, startup, loss, (h1, h2) = _mlp(pkg)
            with pkg.guard(main, startup):
                pg = pkg.backward(loss, checkpoints=[h1, h2] if ck else None)
            built[pkg is PORT] = (main, startup, loss, pg)
        (jm, js, jl, jpg), (tm, _, tl, tpg) = built[False], built[True]
        assert tm.to_json() == jm.to_json()
        if ck:
            types_ = [op.type for op in tm.global_block().ops]
            assert "optimization_barrier" in types_
            assert any("@RCP" in n for op in tm.global_block().ops
                       for n in op.output_names())
        jscope, jexe, tscope, texe = _start(js)
        fetch = [jl.name] + [g.name for _, g in jpg]
        a = jexe.run(jm, feed=feed, fetch_list=fetch, scope=jscope)
        b = texe.run(tm, feed=feed, fetch_list=fetch, scope=tscope)
        for n, u, v in zip(fetch, b, a):
            np.testing.assert_allclose(u, v, rtol=1e-5, atol=1e-6,
                                       err_msg=n)
        grads[ck] = b
    for u, v in zip(grads[True], grads[False]):
        np.testing.assert_array_equal(u, v)


def test_recompute_optimizer_trains_like_the_reference():
    built = {}
    for pkg in (JAX, PORT):
        def minimize(loss, ck, pkg=pkg):
            opt = pkg.O.RecomputeOptimizer(pkg.O.SGD(0.1))
            with pytest.raises(ValueError, match="_set_checkpoints"):
                opt.minimize(loss)
            opt._set_checkpoints(list(ck))
            opt.minimize(loss)
        main, startup, loss, _ = _mlp(pkg, minimize=minimize)
        built[pkg is PORT] = (main, startup, loss)
    (jm, js, jl), (tm, _, tl) = built[False], built[True]
    assert tm.to_json() == jm.to_json()
    jscope, jexe, tscope, texe = _start(js)
    losses = _steps(jm, tm, jl.name, tl.name, [_batch()] * 5, jscope, jexe,
                    tscope, texe)
    for a, b in losses:
        assert abs(b - a) <= 1e-5 * abs(a), losses
    assert losses[-1][1] < losses[0][1]
    _params_close(jscope, tscope, [p.name for p in jm.all_parameters()])


# -------------------------------------------------------- gradient merge
def _merge_program(pkg, k, avg=True):
    strategy = pkg.Strategy()
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": k, "avg": avg}
    f = _init(pkg, strategy)
    main, startup, loss, _ = _mlp(
        pkg, minimize=lambda loss, ck: f.distributed_optimizer(
            pkg.O.SGD(1e-1)).minimize(loss))
    return f, main, startup, loss


def test_gradient_merge_frozen_then_one_merged_step():
    """k_steps 4 under SGD: the reference's op list; parameters frozen
    bit for bit over steps 1-3; after step 4 one SGD step on the four
    slices' whole batch (the mean of the slices' means), within 1e-5;
    both against the reference's merged run. (Under AdamW a frozen step
    still decays: gated zero gradients are not no-ops.)"""
    feeds = [_batch(bs=8, seed=i) for i in range(4)]
    (jf, jm, js, jl), (tf, tm, _, tl) = (_merge_program(JAX, 4),
                                         _merge_program(PORT, 4))
    assert tm.to_json() == jm.to_json()
    assert tf.main_program._program is tm
    jscope, jexe, tscope, texe = _start(js)
    names = [p.name for p in jm.all_parameters()]
    start = {n: tscope.get_numpy(n) for n in names}
    for i, feed in enumerate(feeds):
        jexe.run(jf.main_program, feed=feed, fetch_list=[jl], scope=jscope)
        texe.run(tf.main_program, feed=feed, fetch_list=[tl], scope=tscope)
        if i < 3:
            for n in names:
                np.testing.assert_array_equal(tscope.get_numpy(n), start[n])
    _params_close(jscope, tscope, names)
    # one plain SGD step on the concatenated batch
    pm, ps, pl, _ = _mlp(PORT, minimize=lambda loss, ck:
                         TO.SGD(1e-1).minimize(loss))
    pscope, pexe = Scope(), Executor("cpu")
    pexe.run(ps, scope=pscope)
    for n in names:
        pscope.set_var(n, start[n])
    whole = {k: np.concatenate([f[k] for f in feeds]) for k in feeds[0]}
    pexe.run(pm, feed=whole, fetch_list=[pl], scope=pscope)
    for n in names:
        np.testing.assert_allclose(tscope.get_numpy(n), pscope.get_numpy(n),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


# ------------------------------------------------------------ the chain
def _chain(pkg, *, k=2):
    strategy = pkg.Strategy()
    strategy.amp = True
    strategy.recompute = True
    strategy.gradient_merge = True
    strategy.gradient_merge_configs = {"k_steps": k, "avg": True}
    f = _init(pkg, strategy)

    def minimize(loss, rate, checkpoints):
        strategy.recompute_configs = {
            "checkpoints": [c.name for c in checkpoints]}
        f.distributed_optimizer(pkg.O.AdamW(learning_rate=rate,
                                            weight_decay=0.01)) \
            .minimize(loss)

    static = JSTATIC if pkg is JAX else None
    main, startup, loss = build_encoder_program(
        **ENC, lr=LR, static=static, minimize=minimize)
    return f, main, startup, loss


def test_fleet_chain_matches_the_reference():
    """AMP, recompute and gradient merge (k 2) around AdamW through
    ``fleet.distributed_optimizer``: the reference's program (its ops in
    its order) and its losses and parameters over four steps (composed
    attention; the AMP test above takes the flash route)."""
    (jf, jm, js, jl), (tf, tm, _, tl) = _chain(JAX), _chain(PORT)
    assert tm.to_json() == jm.to_json()
    types_ = [op.type for op in tm.global_block().ops]
    for t in ("cast", "optimization_barrier", "elementwise_mod", "adamw"):
        assert t in types_, t
    jscope, jexe, tscope, texe = _start(js)
    rng = np.random.RandomState(5)
    feeds = [{"x": rng.randn(2, ENC["seq"], ENC["d_model"])
              .astype(np.float32)} for _ in range(4)]
    losses = _steps(jf.main_program, tf.main_program, jl.name, tl.name,
                    feeds, jscope, jexe, tscope, texe)
    for a, b in losses:
        assert np.isfinite(b) and abs(b - a) <= 1e-5 * abs(a), losses
    for p in jm.all_parameters():
        err = np.abs(tscope.get_numpy(p.name) - jscope.get_numpy(p.name))
        # two apply steps in four
        assert err.max() <= 2 * 2 * LR + 1e-6, (p.name, err.max())


@pytest.mark.parametrize("swap,op", [("lamb", "lamb"),
                                     ("lars", "lars_momentum")])
def test_lamb_and_lars_swap_the_inner_optimizer(swap, op):
    progs = {}
    for pkg in (JAX, PORT):
        strategy = pkg.Strategy()
        setattr(strategy, swap, True)
        f = _init(pkg, strategy)
        main, _, _, _ = _mlp(
            pkg, minimize=lambda loss, ck, f=f, pkg=pkg:
            f.distributed_optimizer(pkg.O.Momentum(0.1, 0.9))
            .minimize(loss))
        progs[pkg is PORT] = main
    assert progs[True].to_json() == progs[False].to_json()
    types_ = [o.type for o in progs[True].global_block().ops]
    assert types_.count(op) == 6 and "momentum" not in types_


# ----------------------------------------------------- one rank, waiting
def test_strategy_role_maker_and_parallel_env_follow_the_reference(
        monkeypatch):
    from paddle_tpu.distributed import parallel as jparallel
    from paddle_tpu.distributed.fleet.role_maker import \
        PaddleCloudRoleMaker as JRole
    from paddle_tpu_torch.distributed.fleet.role_maker import \
        PaddleCloudRoleMaker as TRole
    s, j = TStrategy(), JStrategy()
    s.amp = j.amp = True
    s.gradient_merge_configs = j.gradient_merge_configs = {"k_steps": 4}
    assert s.to_dict() == j.to_dict() and repr(s) == repr(j)
    with pytest.raises(AttributeError):
        s.no_such_field = 1
    monkeypatch.setenv("PADDLE_TRAINER_ID", "0")
    monkeypatch.setenv("PADDLE_TRAINER_ENDPOINTS", "a:1")
    r, q = TRole(), JRole()
    assert (r.worker_index(), r.worker_num(), r.get_trainer_endpoints(),
            r.is_first_worker()) == (q.worker_index(), q.worker_num(),
                                     q.get_trainer_endpoints(),
                                     q.is_first_worker())
    pe = tparallel.init_parallel_env()
    assert (pe.rank, pe.world_size) == (0, 1)
    assert tparallel.get_rank() == jparallel.get_rank() == 0
    assert tparallel.get_world_size() == 1
    assert tenv.current_data_axis() == "dp" and tenv.axis_for_ring(0) == "dp"
    f = _init(PORT)
    assert tfb._DistributedOptimizer(f, TO.SGD(0.1), TStrategy())._nranks() \
        == 1


def test_what_runs_across_ranks_or_elsewhere_raises_naming_its_item(
        monkeypatch):
    f = _init(PORT)
    prog = Program()
    for call in (lambda: tfb._insert_grad_allreduce(prog, [], 2, dgc=True),
                 lambda: tfb._apply_sharding_stage2(prog, None, [], 2),
                 lambda: tfb._apply_localsgd(prog, [], 2, 4),
                 lambda: f.distributed_model(object()),
                 lambda: tenv.build_mesh(("dp",), (2,)),
                 lambda: tenv.build_mesh(("dp",), devices=["cpu", "cpu"])):
        with pytest.raises(NotImplementedError, match="A5"):
            call()
    # the elastic manager waits for A8 (the checkpoint plane); the PS
    # lifecycle and fleet.utils' fs / KV server (A7.4) are ported: with
    # no server endpoints init_server keeps the tables in-process and
    # run_server has nothing to serve
    with pytest.raises(NotImplementedError, match="A8"):
        tfleet_mod.elastic
    from paddle_tpu_torch.distributed.ps import runtime as truntime
    assert f.init_server() is None
    with pytest.raises(RuntimeError, match="init_server"):
        f.run_server()
    f.init_worker()
    assert truntime.get_communicator().mode == "sync"
    f.stop_worker()
    assert truntime.get_communicator() is None
    from paddle_tpu_torch.distributed.fleet.utils import fs as tfs
    assert tfleet_mod.util.fs is tfs
    assert tfleet_mod.util.LocalFS is tfs.LocalFS
    with pytest.raises(NotImplementedError, match="A7.5"):
        tfleet_mod.util.recompute(lambda x: x, 1)
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(NotImplementedError, match="A5"):
        tparallel.init_parallel_env()
    assert tparallel.get_world_size() == 2
    monkeypatch.delenv("PADDLE_TRAINERS_NUM")
    from paddle_tpu.distributed.fleet import metrics as jmetrics
    m = tfleet_mod.metrics
    v = np.array([1.0, 2.0])
    for name in ("sum", "max", "min"):
        np.testing.assert_array_equal(getattr(m, name)(v),
                                      getattr(jmetrics, name)(v))
    assert m.acc(3, 4) == jmetrics.acc(3, 4)
    assert m.mean(2.0, 3) == jmetrics.mean(2.0, 3)
    pos, neg = [3, 1, 0, 2], [0, 2, 4, 1]
    assert m.auc(pos, neg) == jmetrics.auc(pos, neg)
