"""The port's ``jit`` against ``paddle_tpu.jit`` on the CPU, where the
port runs each step eagerly (a CUDA graph needs the card; chip_smoke.py
holds the captured step bit-equal to the eager one there), plus
``GPTConfig.recompute`` against JAX's and the in-place AdamW state that
capture relies on.

As in ``test_train_step_matches_jax``, one JAX step builds the optimizer
state and weights and state are carried to the port
(``models/convert.py``): from a fresh state Adam's first update is lr
times the gradient's sign, and gradients that are rounding noise (the
key projection's bias) would flip it. Then both sides run
``bench.py``'s step (auto_cast, loss, clear, backward, AdamW) through
``to_static`` and ``to_static_multi_step``. O2 keeps bench.py's bf16
moments; O0 stores f32 moments: a gradient that differs by float
rounding can flip the bf16 rounding of a stored moment, which moves the
next step's update by ~2^-8 of it (2.5e-6 at lr 1e-3), past the O0
tolerance, while one step alone stays within it. Sizes are
``tests/test_torch_training.py``'s GEOM with the attention composed on
both sides (seq 64 is below ``pallas_min_seq``).

Tolerances are ``test_train_step_matches_jax``'s, per step: O0 loss
within 1e-5, O2 loss within 1e-2 relative; each step may move a
parameter differently by 1e-6 (O0) or 5e-4 (O2, Adam's m / sqrt(v)
carries the bf16 gradient differences of small elements), so after k
steps the parameters agree within k times that.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu import jit as jjit
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import jit
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import (adamw_state_from_numpy,
                                             gpt_state_from_numpy)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.optimizer import AdamW

# tests/test_torch_training.py's GEOM
GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64)
LOSS_TOL = {"O0": ("abs", 1e-5), "O2": ("rel", 1e-2)}
STEP_TOL = {"O0": 1e-6, "O2": 5e-4}


def _batches(seed, k):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, GEOM["vocab_size"], size=(k, 2, 64))
    labels = np.roll(ids, -1, axis=2)
    labels[:, 0, -5:] = -100
    return ids.astype(np.int32), labels.astype(np.int32)


def _pair(level, **cfg):
    """The JAX model and its step, and the port's on the same weights,
    each with a fresh AdamW (lr 1e-3; bf16 moments at O2, f32 at O0)."""
    moments = None if level == "O0" else "bfloat16"
    pt.seed(7)
    jm = JGPT(JGPTConfig(**GEOM, **cfg))
    jopt = JAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                  moment_dtype=moments)
    named = list(jm.named_parameters())
    tm = GPTForCausalLM(GPTConfig(**GEOM, **cfg), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(
        {n: np.array(p.value) for n, p in named}, "cpu"), strict=True)
    topt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                 moment_dtype=moments)
    amp_on = level != "O0"

    def jstep(ids, labels):
        with jamp.auto_cast(enable=amp_on, level="O2"):
            loss = jm(ids, labels=labels)
        jm.clear_gradients()
        loss.backward()
        jopt.step()
        return loss

    def tstep(ids, labels):
        with tamp.auto_cast(enable=amp_on, level="O2"):
            loss = tm(ids, labels=labels)
        topt.clear_grad()
        loss.backward()
        topt.step()
        return loss

    return (jm, jopt, jstep), (tm, topt, tstep), named


def _carried(level):
    """:func:`_pair` after one JAX ``to_static`` step whose weights and
    AdamW state are carried to the port; returns the JAX side's
    ``to_static`` step too."""
    (jm, jopt, jstep), (tm, topt, tstep), named = _pair(level)
    jfast = jjit.to_static(jstep, layers=[jm], optimizers=[jopt])
    ids, labels = _batches(100, 1)
    jfast(ids[0], labels[0])
    tm.load_state_dict(gpt_state_from_numpy(
        {n: np.array(p.value) for n, p in named}, "cpu"), strict=True)
    state = {k: (v if k == "_lr" else np.array(v))
             for k, v in jopt.state_dict().items()}
    topt.set_state_dict(adamw_state_from_numpy(
        state, {p.name: n for n, p in named}, "cpu"))
    return (jm, jopt, jstep, jfast), (tm, topt, tstep), named


def _jloss(out):
    return np.asarray(out.value, np.float32)


def _hold(level, tloss, jloss, named, tm, steps):
    kind, tol = LOSS_TOL[level]
    tloss = tloss.float().numpy()
    scale = np.abs(jloss) if kind == "rel" else 1.0
    assert np.all(np.abs(tloss - jloss) <= tol * scale), (tloss, jloss)
    tparams = dict(tm.named_parameters())
    for n, p in named:
        np.testing.assert_allclose(tparams[n].detach().numpy(),
                                   np.asarray(p.value), rtol=0,
                                   atol=steps * STEP_TOL[level], err_msg=n)


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_to_static_matches_jax(level):
    """Three ``to_static`` calls on three batches: the loss of each and
    the parameters after it."""
    (_, _, _, jfast), (tm, topt, tstep), named = _carried(level)
    tfast = jit.to_static(tstep, layers=[tm], optimizers=[topt])
    ids, labels = _batches(1, 3)
    for k in range(3):
        jl = _jloss(jfast(ids[k], labels[k]))
        tl = tfast(ids[k], labels[k])
        assert not tl.requires_grad
        _hold(level, tl, jl, named, tm, k + 1)


def test_to_static_multi_step_matches_jax():
    """One ``to_static`` step, then ``to_static_multi_step`` over K = 3
    (O2, bench.py's level): the stacked losses and the parameters."""
    (jm, jopt, jstep, jfast), (tm, topt, tstep), named = _carried("O2")
    ids, labels = _batches(2, 4)
    jl0 = _jloss(jfast(ids[0], labels[0]))
    tl0 = jit.to_static(tstep, layers=[tm], optimizers=[topt])(
        ids[0], labels[0])
    _hold("O2", tl0, jl0, named, tm, 1)
    jl = _jloss(jjit.to_static_multi_step(jstep, layers=[jm],
                                          optimizers=[jopt])(
        ids[1:], labels[1:]))
    tl = jit.to_static_multi_step(tstep, layers=[tm], optimizers=[topt])(
        torch.from_numpy(ids[1:]), labels[1:])
    assert tl.shape == (3,) and jl.shape == (3,)
    _hold("O2", tl, jl, named, tm, 4)


def test_multi_step_shares_the_single_step_and_needs_a_prior_step():
    (_, _, _), (tm, topt, tstep), _ = _pair("O0")
    multi = jit.to_static_multi_step(tstep, layers=[tm], optimizers=[topt])
    ids, labels = _batches(3, 2)
    with pytest.raises(RuntimeError, match="one to_static step first"):
        multi(ids, labels)
    single = jit.to_static(tstep, layers=[tm], optimizers=[topt])
    assert single._step is multi._step
    single(ids[0], labels[0])
    with pytest.raises(ValueError, match="leading step dimension"):
        multi(ids, labels[0, :1])
    assert multi(ids, labels).shape == (2,)


def test_retain_grads_false_leaves_every_grad_none():
    (_, _, _), (tm, topt, tstep), _ = _pair("O0")
    ids, labels = _batches(4, 3)
    kept = jit.to_static(tstep, layers=[tm], optimizers=[topt])
    kept(ids[0], labels[0])
    assert all(p.grad is not None for p in tm.parameters())
    dropped = jit.to_static(tstep, layers=[tm], optimizers=[topt],
                            retain_grads=False)
    dropped(ids[1], labels[1])
    assert all(p.grad is None for p in tm.parameters())
    jit.to_static_multi_step(tstep, layers=[tm], optimizers=[topt],
                             retain_grads=False)(ids[1:], labels[1:])
    assert all(p.grad is None for p in tm.parameters())


def test_forward_only_to_static_equals_the_model():
    (_, _, _), (tm, _, _), _ = _pair("O0")
    ids = torch.from_numpy(_batches(5, 1)[0][0])
    fast = jit.to_static(tm)
    out = fast(ids)
    assert not out.requires_grad
    assert torch.equal(out, tm(ids).detach())


def test_capture_key_follows_shape_dtype_grads_and_flags():
    (_, _, _), (tm, topt, tstep), _ = _pair("O0")
    step = jit.to_static(tstep, layers=[tm], optimizers=[topt])._step
    ids, labels = (torch.from_numpy(a[0]) for a in _batches(6, 1))
    key = step.key([ids, labels])
    assert step.key([ids.clone(), labels.clone()]) == key
    assert step.key([ids[:1], labels[:1]]) != key          # shape
    assert step.key([ids.long(), labels]) != key           # dtype
    assert step.key([ids.numpy(), labels]) == key          # arrays as tensors
    p = next(tm.parameters())
    p.grad = torch.zeros_like(p)
    assert step.key([ids, labels]) != key                  # grads present
    p.grad = None
    assert step.key([ids, labels]) == key
    saved = tflags.get_flags(["pallas_min_seq"])
    try:
        tflags.set_flags(saved)
        assert step.key([ids, labels]) != key              # flags version
    finally:
        tflags.set_flags(saved)
    with pytest.raises(TypeError, match="hashable"):
        step.key([ids, [1, 2]])
    with pytest.raises(NotImplementedError, match="mesh"):
        jit.to_static(tstep, layers=[tm], mesh=object())
    with pytest.raises(NotImplementedError, match="converter"):
        jit.to_static(tstep, layers=[tm], ast_convert=True)


def _loss_and_grads(tm, ids, labels, level):
    with tamp.auto_cast(enable=level != "O0", level="O2"):
        loss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tm.zero_grad(set_to_none=True)
    loss.backward()
    return loss.detach(), {n: p.grad.clone()
                           for n, p in tm.named_parameters()}


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_recompute_equals_no_recompute(level):
    """Checkpointed blocks recompute exactly what the forward computed,
    under the forward's AMP level: loss and gradients bit-equal."""
    ids, labels = (a[0] for a in _batches(7, 1))
    (_, _, _), (plain, _, _), _ = _pair(level)
    (_, _, _), (rc, _, _), _ = _pair(level, recompute=True)
    la, ga = _loss_and_grads(plain, ids, labels, level)
    lb, gb = _loss_and_grads(rc, ids, labels, level)
    assert torch.equal(la, lb)
    for n in ga:
        assert torch.equal(ga[n], gb[n]), n


def test_recompute_matches_jax_recompute():
    """JAX's recompute=True (``fleet.utils.recompute`` over each block,
    here inside its compiled step, as bench.py runs it) and the port's,
    at O0 and dropout 0: the loss within 1e-5 and the gradients of the
    step within 1e-4 (test_train_step_matches_jax's O0 tolerances)."""
    ids, labels = (a[0] for a in _batches(8, 1))
    (jm, jopt, jstep), (tm, _, _), named = _pair("O0", recompute=True)
    jloss = jjit.to_static(jstep, layers=[jm], optimizers=[jopt])(ids,
                                                                  labels)
    tloss, tgrads = _loss_and_grads(tm, ids, labels, "O0")
    assert abs(float(tloss) - float(_jloss(jloss))) <= 1e-5
    for n, p in named:
        np.testing.assert_allclose(tgrads[n].numpy(),
                                   np.asarray(p.grad.value), rtol=1e-4,
                                   atol=1e-4, err_msg=n)


def test_recompute_replays_dropout_and_refuses_capture(monkeypatch):
    """With dropout the recomputation draws the forward's masks again (the
    saved RNG state): gradients equal the plain model's from the same
    seed. Under a capture that replay is not possible, and the forward
    raises naming the limit."""
    ids, labels = (a[0] for a in _batches(9, 1))
    out = []
    for recompute in (False, True):
        (_, _, _), (tm, _, _), _ = _pair("O0", dropout=0.1,
                                         recompute=recompute)
        torch.manual_seed(11)
        out.append(_loss_and_grads(tm, ids, labels, "O0"))
    assert torch.equal(out[0][0], out[1][0])
    for n in out[0][1]:
        assert torch.equal(out[0][1][n], out[1][1][n]), n
    monkeypatch.setattr(tgpt, "capturing", lambda: True)
    with pytest.raises(NotImplementedError, match="dropout > 0"):
        tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tm.eval()                 # no dropout drawn: nothing to replay
    tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))


def test_adamw_keeps_its_state_tensors():
    """Moments, beta powers and parameters keep their tensors (data_ptr
    and identity) across steps, and state_dict hands out those tensors;
    set_state_dict copies into them."""
    (_, _, _), (tm, topt, tstep), _ = _pair("O2")
    ids, labels = _batches(10, 3)
    tstep(torch.from_numpy(ids[0]), torch.from_numpy(labels[0]))
    state = topt.state_dict()
    ptrs = {k: v.data_ptr() for k, v in state.items() if k != "_lr"}
    pptrs = [p.data_ptr() for p in tm.parameters()]
    snap = {k: (v.clone() if k != "_lr" else v) for k, v in state.items()}
    for k in (1, 2):
        tstep(torch.from_numpy(ids[k]), torch.from_numpy(labels[k]))
    now = topt.state_dict()
    assert {k: v.data_ptr() for k, v in now.items() if k != "_lr"} == ptrs
    assert all(now[k] is state[k] for k in ptrs)
    assert [p.data_ptr() for p in tm.parameters()] == pptrs
    assert not all(torch.equal(now[k], snap[k]) for k in ptrs)
    topt.set_state_dict(snap)
    assert {k: v.data_ptr() for k, v in topt.state_dict().items()
            if k != "_lr"} == ptrs
    assert all(torch.equal(now[k], snap[k]) for k in ptrs)
    topt.set_lr(0.5)
    assert topt.get_lr() == 0.5
    assert all(float(t) == 0.5 for t in topt._lr.values())


def test_launch_counts_round_trip():
    """The capture's bookkeeping: every kernel wrapper's count is read,
    and a replay's delta is added where it belongs."""
    counts = jit.launch_counts()
    assert ("adamw", "adamw", None) in counts
    assert ("flash_attention", "flash_fwd", "wgmma") in counts
    assert ("paged_attention", None, None) in counts
    delta = {("adamw", "adamw", None): 2,
             ("flash_attention", "flash_fwd", "wgmma"): 3,
             ("paged_attention", None, None): 1}
    try:
        jit._add_launch_counts(delta)
        now = jit.launch_counts()
        assert {k: now[k] - counts[k] for k in now
                if now[k] != counts[k]} == delta
    finally:
        jit._set_launch_counts(counts)
    assert jit.launch_counts() == counts


class _FakeGraph:
    """Stands in for a ``torch.cuda.CUDAGraph``: ``replay`` runs ``fn``."""

    def __init__(self, fn):
        self.replay = fn


def test_replay_binds_gradients_and_copies_only_what_it_reads():
    """A replay binds each ``p.grad`` to the graph's gradient output. A
    gradient the captured step accumulated into (a, in place) is the
    output itself; it is copied into only when the caller rebound
    ``p.grad`` since. A gradient the step cleared (b) is neither read nor
    written, and the graph keeps no reference to it."""
    a = torch.nn.Parameter(torch.zeros(3))
    b = torch.nn.Parameter(torch.zeros(3))
    acc, out_b = torch.ones(3), torch.zeros(3)

    def replay():
        acc.add_(1.0)
        out_b.fill_(7.0)

    graph = jit._Graph(_FakeGraph(replay), [], torch.tensor(2.0), {},
                       [acc, None], [acc, out_b])
    a.grad, b.grad = acc, torch.full((3,), 5.0)
    found_b = b.grad
    out = graph.run([a, b])
    assert a.grad is acc and b.grad is out_b
    assert torch.equal(acc, torch.full((3,), 2.0))
    assert torch.equal(out_b, torch.full((3,), 7.0))
    assert torch.equal(found_b, torch.full((3,), 5.0))
    assert out is not graph.outputs and torch.equal(out, graph.outputs)
    a.grad = torch.full((3,), 10.0)
    graph.run([a, b])
    assert a.grad is acc and torch.equal(acc, torch.full((3,), 11.0))


def test_capture_refuses_a_second_order_step():
    """A step whose gradients carry a ``grad_fn`` (create_graph=True
    accumulates out of place, reading gradients a replay does not keep)
    is refused."""
    layer = torch.nn.Linear(2, 2)
    step = jit._Step(lambda: None, [layer], [], True)
    ptrs = [p.data_ptr() for p in step.params]
    x = torch.ones(2, requires_grad=True)
    second = [(x * 2).sum().expand(2, 2), None]
    step._check_in_place(ptrs, [], [None, torch.zeros(2)])
    with pytest.raises(RuntimeError, match="create_graph"):
        step._check_in_place(ptrs, [], second)


def test_dataclass_field_matches_jax():
    assert GPTConfig().recompute is False
    assert dataclasses.replace(GPTConfig(), recompute=True).recompute
    assert {f.name for f in dataclasses.fields(GPTConfig)} <= \
        {f.name for f in dataclasses.fields(JGPTConfig)}


def test_capture_refuses_a_rebound_buffer():
    """A captured step must update its layers' buffers (BatchNorm's
    running statistics) in place: one that rebinds a buffer is refused,
    as one that rebinds a parameter is."""
    bn = torch.nn.BatchNorm1d(3)
    step = jit._Step(lambda: None, [bn], [], True)
    ptrs = step.buffer_ptrs()
    assert len(ptrs) == 3          # running mean, var, batches tracked
    step._check_buffers(ptrs)
    with torch.no_grad():
        bn.running_mean.mul_(0.5)  # in place: accepted
    step._check_buffers(ptrs)
    bn.running_mean = torch.zeros(3)
    with pytest.raises(RuntimeError, match="rebound a buffer"):
        step._check_buffers(ptrs)


def test_capture_pins_the_lr_slots(monkeypatch):
    """A captured step reads each parameter's learning-rate slot, so a
    capture (stubbed here: the CPU has no CUDA graphs, and the fake
    graph's replay runs the step) pins the slots. After it a new learning
    rate still reaches the replays, refreshed in place, while an
    ``lr_scale`` that would move a parameter to another slot (or grow the
    lr tensor) raises before the replay instead of leaving the graph on
    the old slot."""
    from paddle_tpu_torch import optimizer as topt

    layer = torch.nn.Linear(2, 1)
    with torch.no_grad():
        layer.weight.zero_()
        layer.bias.zero_()
    opt = topt.SGD(0.1, parameters=layer.named_parameters())

    def fn(x):
        opt.clear_grad()
        layer(x).sum().backward()
        opt.step()

    step = jit._Step(fn, [layer], [opt], False)
    monkeypatch.setattr(step, "device", lambda args: torch.device("cpu"))
    monkeypatch.setattr(jit, "warm_up", lambda dev, f, *a: f(*a))
    monkeypatch.setattr(jit, "capture", lambda dev, f, a, pool=None: (
        _FakeGraph(lambda: f(*a)), f(*a), {}))
    x = torch.ones(2)
    step(x)                          # warm-up
    step(x)                          # capture (a step) and its replay
    assert len(step.graphs) == 1
    assert torch.equal(layer.bias.detach(), torch.full((1,), -0.3))
    opt.set_lr(0.5)
    step(x)
    assert torch.equal(layer.bias.detach(), torch.full((1,), -0.8))
    layer.bias.lr_scale = 2.0
    with pytest.raises(RuntimeError, match="lr_scale changed after a "
                                           "captured step"):
        step(x)
    assert torch.equal(layer.bias.detach(), torch.full((1,), -0.8))
    layer.bias.lr_scale = 1.0
    step(x)
    assert torch.equal(layer.bias.detach(), torch.full((1,), -1.3))
