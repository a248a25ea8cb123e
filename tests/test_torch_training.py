"""The port's training path against the JAX package on the CPU:
cross-entropy with ignored labels, the AMP casts per op type, AdamW on
identical gradients (f32 and bf16 moments), and a whole GPT train step
(forward with labels, backward, AdamW) after carrying weights and
optimizer state across, at AMP O0 and O2, with the attention on the
flash route on both sides (``pallas_min_seq`` lowered; the JAX kernel
in Pallas interpret mode, the port's plain functions).

Tolerances: cross-entropy and AdamW differ only by float rounding order
(1e-6). O0 train step: loss within 1e-5, gradients within 1e-4 (the
attention sums run in another order), parameters after the step within
1e-6. O2: bf16 rounds at other places in XLA:CPU and torch, so the loss
is held within 1e-2 relative, each f32 gradient within 3e-2 relative
Frobenius error and the parameters within half a learning rate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.flags as jflags
from paddle_tpu import amp as jamp
from paddle_tpu.amp.auto_cast import maybe_autocast_inputs as jcast
from paddle_tpu.dygraph.tensor import Parameter as JParameter
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.nn import functional as JF
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models.convert import (adamw_state_from_numpy,
                                             gpt_state_from_numpy)
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.ops import attention_ops as tops
from paddle_tpu_torch.optimizer import AdamW

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_with_ignored_labels(reduction):
    rng = np.random.RandomState(0)
    logits = rng.randn(12, 7).astype(np.float32)
    labels = rng.randint(0, 7, size=(12, 1)).astype(np.int32)
    labels[[1, 4, 5]] = -100
    jx = Tensor(jnp.asarray(logits), stop_gradient=False)
    jloss = JF.cross_entropy(jx, Tensor(jnp.asarray(labels)),
                             ignore_index=-100, reduction=reduction)
    jloss.sum().backward() if reduction == "none" else jloss.backward()
    tx = torch.from_numpy(logits).requires_grad_()
    tloss = TF.cross_entropy(tx, torch.from_numpy(labels),
                             ignore_index=-100, reduction=reduction)
    (tloss.sum() if reduction == "none" else tloss).backward()
    np.testing.assert_allclose(tloss.detach().numpy(), jloss.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx.grad.value),
                               rtol=1e-6, atol=1e-6)
    assert float(tx.grad[[1, 4, 5]].abs().max()) == 0.0
    if reduction == "mean":      # mean over the 9 labels kept, not 12
        per_row = TF.cross_entropy(tx, torch.from_numpy(labels),
                                   reduction="none")
        assert float(tloss.detach()) == pytest.approx(
            float(per_row.detach().sum()) / 9)


OP_TYPES = ["matmul_v2", "fused_attention_qkv", "layer_norm",
            "softmax_with_cross_entropy", "reduce_sum", "elementwise_add",
            "elementwise_div", "elementwise_max", "gelu", "lookup_table_v2"]


@pytest.mark.parametrize("level", ["O1", "O2"])
@pytest.mark.parametrize("op_type", OP_TYPES)
def test_amp_casts_follow_maybe_autocast_inputs(level, op_type):
    """Each input's dtype after the port's cast equals the reference's
    for the same op type, level and input dtypes; O0 casts nothing."""
    vals = [np.ones((2, 3), np.float32), np.ones((2, 3), np.float32),
            np.ones((2, 3), np.int32)]
    jdts = [jnp.float32, jnp.bfloat16, jnp.int32]
    tdts = [torch.float32, torch.bfloat16, torch.int32]
    jins = {"X": [Tensor(jnp.asarray(v, dt)) for v, dt in zip(vals, jdts)]}
    with jamp.auto_cast(level=level):
        jout = jcast(op_type, jins, "bfloat16", level)["X"]
    tins = [torch.from_numpy(v).to(dt) for v, dt in zip(vals, tdts)]
    with tamp.auto_cast(level=level):
        tout = tamp.maybe_autocast_inputs(op_type, *tins, None)
    assert tout[-1] is None
    assert [str(t.dtype).replace("torch.", "") for t in tout[:-1]] == \
        [str(t.value.dtype) for t in jout]
    with tamp.auto_cast(enable=False, level=level):
        assert tamp.maybe_autocast_inputs(op_type, *tins) == tuple(tins)


def test_amp_casts_are_differentiable():
    """Under O2 an f32 master weight feeds a bf16 product and still gets
    an f32 gradient."""
    w = torch.ones(3, 2, requires_grad=True)
    with tamp.auto_cast(level="O2"):
        y = TF.linear(torch.ones(4, 3), w)
    assert y.dtype == torch.bfloat16
    y.float().sum().backward()
    assert w.grad.dtype == torch.float32
    assert torch.equal(w.grad, torch.full((3, 2), 4.0))


def _jax_params(arrays):
    return [JParameter(jnp.asarray(a), name=f"p{i}")
            for i, a in enumerate(arrays)]


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
def test_adamw_matches_jax_on_identical_gradients(moment_dtype):
    """Three steps on the same numpy gradients: parameters and stored
    moments agree within 1e-6, also after the state is carried across
    mid-way with ``adamw_state_from_numpy``."""
    rng = np.random.RandomState(3)
    shapes = [(5, 4), (4,), (3, 2, 2)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    jps = _jax_params(init)
    jopt = JAdamW(learning_rate=1e-3, parameters=jps, weight_decay=0.01,
                  moment_dtype=moment_dtype)
    tps = [torch.nn.Parameter(torch.from_numpy(a.copy())) for a in init]
    topt = AdamW(learning_rate=1e-3,
                 parameters=[(f"p{i}", p) for i, p in enumerate(tps)],
                 weight_decay=0.01, moment_dtype=moment_dtype)
    for step in range(3):
        grads = [rng.randn(*s).astype(np.float32) * 1e-2 for s in shapes]
        for jp, tp, g in zip(jps, tps, grads):
            jp.grad = Tensor(jnp.asarray(g))
            tp.grad = torch.from_numpy(g)
        jopt.step()
        topt.step()
        for jp, tp in zip(jps, tps):
            np.testing.assert_allclose(tp.detach().numpy(),
                                       np.asarray(jp.value), rtol=0,
                                       atol=1e-6)
        jstate = {k: (v if k == "_lr" else np.asarray(v))
                  for k, v in jopt.state_dict().items()}
        tstate = topt.state_dict()
        assert set(jstate) == set(tstate)
        for k, v in jstate.items():
            if k == "_lr":
                continue
            assert str(tstate[k].dtype).replace("torch.", "") == \
                str(v.dtype)
            np.testing.assert_allclose(tstate[k].float().numpy(),
                                       v.astype(np.float32), rtol=0,
                                       atol=1e-6, err_msg=k)
        if step == 0:       # continue on a fresh optimizer from carried state
            topt = AdamW(learning_rate=0.5,
                         parameters=[(f"p{i}", p) for i, p in enumerate(tps)],
                         weight_decay=0.01, moment_dtype=moment_dtype)
            topt.set_state_dict(adamw_state_from_numpy(
                jstate, {f"p{i}": f"p{i}" for i in range(3)}, "cpu"))
            assert topt.get_lr() == 1e-3


def test_adamw_takes_named_parameters_only():
    with pytest.raises(TypeError, match="named_parameters"):
        AdamW(parameters=[torch.nn.Parameter(torch.zeros(2))])


@pytest.fixture
def flash_from_64(monkeypatch):
    """Flash route from 64 tokens with 32-row blocks on both sides, the
    port's calls counted."""
    names = ["use_pallas_attention", "pallas_min_seq", "pallas_flash_block_q",
             "pallas_flash_block_k"]
    saved = (jflags.get_flags(names), tflags.get_flags(names))
    new = {"use_pallas_attention": True, "pallas_min_seq": 64,
           "pallas_flash_block_q": 32, "pallas_flash_block_k": 32}
    jflags.set_flags(new)
    tflags.set_flags(new)
    calls = []
    real = tops.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].dtype)
        return real(*a, **kw)

    monkeypatch.setattr(tops, "flash_attention", spy)
    yield calls
    jflags.set_flags(saved[0])
    tflags.set_flags(saved[1])


def _batch(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, GEOM["vocab_size"], size=(2, 64))
    labels = np.roll(ids, -1, axis=1)
    labels[0, -5:] = -100
    return ids.astype(np.int32), labels.astype(np.int32)


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_train_step_matches_jax(flash_from_64, level):
    """One JAX step builds the optimizer state; weights and state are
    carried to the port; then one more step on both (bench.py's step:
    auto_cast, loss, clear, backward, AdamW with bf16 moments) must give
    the same loss and gradients, and parameters that stay close."""
    pt.seed(7)
    jm = JGPT(JGPTConfig(**GEOM))
    jopt = JAdamW(learning_rate=1e-3, parameters=jm.parameters(),
                  moment_dtype="bfloat16")

    def jstep(ids, labels):
        with jamp.auto_cast(enable=level != "O0", level="O2"):
            loss = jm(Tensor(jnp.asarray(ids)), labels=Tensor(
                jnp.asarray(labels)))
        jm.clear_gradients()
        loss.backward()
        jopt.step()
        return loss

    jstep(*_batch(0))
    named = list(jm.named_parameters())
    arrays = {n: np.array(p.value) for n, p in named}
    jstate = {k: (v if k == "_lr" else np.array(v))
              for k, v in jopt.state_dict().items()}

    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    topt = AdamW(learning_rate=1e-3, parameters=tm.named_parameters(),
                 moment_dtype="bfloat16")
    topt.set_state_dict(adamw_state_from_numpy(
        jstate, {p.name: n for n, p in named}, "cpu"))

    ids, labels = _batch(1)
    jloss = float(np.asarray(jstep(ids, labels).value, np.float32))
    with tamp.auto_cast(enable=level != "O0", level="O2"):
        tloss = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    tm.zero_grad(set_to_none=True)
    tloss.backward()
    topt.step()
    assert len(flash_from_64) == GEOM["num_layers"]
    assert set(flash_from_64) == {torch.float32 if level == "O0"
                                  else torch.bfloat16}
    tparams = dict(tm.named_parameters())
    if level == "O0":
        assert abs(float(tloss.detach()) - jloss) <= 1e-5
        for n, p in named:
            np.testing.assert_allclose(tparams[n].grad.numpy(),
                                       np.asarray(p.grad.value), rtol=1e-4,
                                       atol=1e-4, err_msg=n)
    else:
        assert tloss.dtype == torch.bfloat16
        assert abs(float(tloss.detach()) - jloss) <= 1e-2 * abs(jloss)
        # f32 master gradients through the casts; the two packages round
        # bf16 at other places, which leaves up to ~1.8e-2 relative
        # (Frobenius) on the biases, about 4.5 bf16 epsilons (2^-8)
        for n, p in named:
            jg = np.asarray(p.grad.value, np.float32)
            tg = tparams[n].grad
            assert tg.dtype == torch.float32, n
            rel = np.linalg.norm(tg.numpy() - jg) / np.linalg.norm(jg)
            assert rel <= 3e-2, (n, rel)
    # each update is about lr (1e-3) in size; at O2 Adam's m / sqrt(v)
    # carries the bf16 gradient differences of small elements
    limit = 1e-6 if level == "O0" else 5e-4
    for n, p in named:
        step = np.asarray(p.value) - arrays[n]
        moved = tparams[n].detach().numpy() - arrays[n]
        assert np.abs(moved - step).max() <= limit, n
