"""The port's ERNIE against the JAX package on the CPU, with the JAX
weights carried across by name: the pretraining outputs with and without
a 2-D keep mask, the sequence classifier, the loss and every gradient
with ``use_pallas_layer_norm`` off and on (on both sides: the JAX
LayerNorm kernels in Pallas interpret mode, the port's plain versions),
the same at AMP O2, one AdamW step, and ``ernie-tiny`` (h 64), which no
LayerNorm kernel takes.

The small model has h 128, so ``h % 128 == 0`` holds and the flag
decides the route: 6 LayerNorms per forward (embeddings, 2 per layer,
the MLM transform).

Tolerances: f32 outputs within 1e-4 and gradients within 1e-4 (sums in
another order); the loss within 1e-5 relative. O2: bf16 rounds at other
places in XLA:CPU and torch, so the loss is held within 1e-2 relative
and each gradient within 3e-2 relative Frobenius error, as
``test_torch_training.py`` holds GPT. The key projection's bias shifts
every logit of a row by the same amount, so its true gradient is zero
and both sides hold rounding noise only: at O2 it is held to 3e-2 of the
norm of the query bias's gradient instead. One AdamW step moves each
parameter by about lr; at f32, after a first step has built the
optimizer state, the two sides agree within 0.1 lr (the key bias aside,
whose noise Adam normalises to steps of random sign). At O2 Adam's
``m / sqrt(v)`` turns the few-percent gradient differences of rarely
hit embedding rows into steps that differ by up to ~2 lr, so the
parameters are not compared there.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
import paddle_tpu.flags as jflags
from paddle_tpu import amp as jamp
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu.models.ernie import ERNIE_CONFIGS as J_CONFIGS
from paddle_tpu.nn import Embedding as JEmbedding
from paddle_tpu.models.ernie import ErnieConfig as JErnieConfig
from paddle_tpu.models.ernie import ErnieForPretraining as JPretraining
from paddle_tpu.models.ernie import \
    ErnieForSequenceClassification as JClassifier
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models.convert import (adamw_state_from_numpy,
                                             gpt_state_from_numpy)
from paddle_tpu_torch.models.ernie import (ERNIE_CONFIGS, ErnieConfig,
                                           ErnieForPretraining,
                                           ErnieForSequenceClassification)
from paddle_tpu_torch.nn.layers_common import Embedding, Linear
from paddle_tpu_torch.ops.cuda import layer_norm as tln
from paddle_tpu_torch.optimizer import AdamW

GEOM = dict(vocab_size=1000, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=256,
            max_position_embeddings=128, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
LR = 1e-3


@pytest.fixture
def ln_route(monkeypatch):
    """``set(on)`` sets ``use_pallas_layer_norm`` on both sides; the list
    collects the row shapes of the port's LayerNorm kernel calls (their
    plain versions on the CPU)."""
    saved = (jflags.get_flag("use_pallas_layer_norm"),
             tflags.get_flag("use_pallas_layer_norm"))
    calls = []
    real = tln.ln_fwd_plain

    def spy(x2, *a):
        calls.append(tuple(x2.shape))
        return real(x2, *a)

    monkeypatch.setattr(tln, "ln_fwd_plain", spy)

    def set_route(on):
        jflags.set_flags({"use_pallas_layer_norm": on})
        tflags.set_flags({"use_pallas_layer_norm": on})
        calls.clear()

    yield set_route, calls
    jflags.set_flags({"use_pallas_layer_norm": saved[0]})
    tflags.set_flags({"use_pallas_layer_norm": saved[1]})


def _pair(jcls, tcls, cfg, seed=0, **kw):
    """A JAX model from ``pt.seed(seed)`` and the port's with its
    weights. The embedding tables are scaled to ERNIE's published
    initializer range (N(0, 0.02²), where the package draws N(0, 1)):
    at N(0, 1) the tied MLM logits reach ~30, where one bf16 step is
    0.125, and the O2 comparison would measure the saturated softmax."""
    pt.seed(seed)
    jm = jcls(JErnieConfig(**cfg), **kw)
    for name, p in jm.named_parameters():
        if name.endswith("embeddings.weight"):
            p.set_value(p.value * 0.02)
    arrays = {n: np.array(p.value) for n, p in jm.named_parameters()}
    tm = tcls(ErnieConfig(**cfg), device="cpu", **kw)
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    return jm, tm, arrays


def _batch(seed, vocab, b=2, s=32):
    """bench.py's ERNIE batch: ids in [3, vocab), MLM labels = ids (a
    few ignored here), random SOP labels; and a keep mask hiding a
    padded tail of the second row."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, (b, s)).astype(np.int32)
    labels = ids.copy()
    labels[0, :4] = -100
    ns = rng.randint(0, 2, (b,)).astype(np.int32)
    keep = np.ones((b, s), np.int32)
    keep[1, s - 7:] = 0
    return ids, labels, ns, keep


def _j(a):
    return Tensor(jnp.asarray(a))


def _t(a):
    return torch.from_numpy(a)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("head", ["pretraining", "classification"])
def test_forward_matches_jax(ln_route, head, masked):
    """``(logits, ns_logits)`` of the pretraining model and the class
    logits of the classifier, with and without a 2-D keep mask, f32."""
    set_route, _ = ln_route
    set_route(False)
    if head == "pretraining":
        jm, tm, _ = _pair(JPretraining, ErnieForPretraining, GEOM)
    else:
        jm, tm, _ = _pair(JClassifier, ErnieForSequenceClassification, GEOM,
                          num_classes=3)
    ids, _, _, keep = _batch(0, GEOM["vocab_size"])
    jmask = _j(keep) if masked else None
    tmask = _t(keep) if masked else None
    jout = jm(_j(ids), attention_mask=jmask)
    with torch.no_grad():
        tout = tm(_t(ids), attention_mask=tmask)
    if head == "classification":
        jout, tout = [jout], [tout]
        assert tuple(tout[0].shape) == (2, 3)
    for j, t in zip(jout, tout):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(t.numpy(), np.asarray(j.value),
                                   rtol=1e-4, atol=1e-4)
    if masked:      # the padded keys change the second row only
        with torch.no_grad():
            free = tm(_t(ids))
        free = free[0] if head == "pretraining" else free
        assert torch.equal(free[0], tout[0][0])
        assert not torch.allclose(free[1], tout[0][1])


def _loss(model, ids, labels, ns, level, wrap):
    amp = jamp if wrap is _j else tamp
    with amp.auto_cast(enable=level != "O0", level="O2"):
        return model(wrap(ids), masked_lm_labels=wrap(labels),
                     next_sentence_label=wrap(ns))


@pytest.fixture(scope="module")
def first_step():
    """The JAX model of the train-step test after bench.py's step at O0
    with the LayerNorm kernels off, which builds the optimizer state:
    ``(jstep, named parameters, their arrays, the optimizer state)``,
    made once for the module and restored by each case before its own
    step. ``jstep(batch, level)`` runs one step and returns the loss."""
    jm, _, _ = _pair(JPretraining, ErnieForPretraining, GEOM, seed=3)
    jopt = JAdamW(learning_rate=LR, parameters=jm.parameters(),
                  moment_dtype="bfloat16")

    def jstep(batch, lvl):
        loss = _loss(jm, *batch, lvl, _j)
        jm.clear_gradients()
        loss.backward()
        jopt.step()
        return float(np.asarray(loss.value, np.float32))

    saved = jflags.get_flag("use_pallas_layer_norm")
    jflags.set_flags({"use_pallas_layer_norm": False})
    try:
        jstep(_batch(0, GEOM["vocab_size"])[:3], "O0")
    finally:
        jflags.set_flags({"use_pallas_layer_norm": saved})
    named = list(jm.named_parameters())
    arrays = {n: np.array(p.value) for n, p in named}
    state = {k: (v if k == "_lr" else np.array(v))
             for k, v in jopt.state_dict().items()}

    def restore():
        for n, p in named:
            p.set_value(jnp.asarray(arrays[n]))
        jopt.set_state_dict(state)

    return jstep, restore, named, arrays, state


@pytest.mark.parametrize("level,route", [("O0", False), ("O0", True),
                                         ("O2", True)])
def test_train_step_matches_jax(ln_route, first_step, level, route):
    """bench.py's step (loss, clear, backward, AdamW with bf16 moments):
    one JAX step at O0 builds the optimizer state; weights and state are
    carried across; then one step on both sides at ``level`` with the
    LayerNorm kernel route off or on must give the same loss and
    gradients and, at f32, parameters within 0.1 lr."""
    set_route, calls = ln_route
    jstep, restore, named, arrays, state = first_step
    restore()
    tm = ErnieForPretraining(ErnieConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    topt = AdamW(learning_rate=LR, parameters=tm.named_parameters(),
                 moment_dtype="bfloat16")
    topt.set_state_dict(adamw_state_from_numpy(
        state, {p.name: n for n, p in named}, "cpu"))

    set_route(route)
    batch = _batch(1, GEOM["vocab_size"])[:3]
    jloss = jstep(batch, level)
    tloss = _loss(tm, *batch, level, _t)
    tm.zero_grad(set_to_none=True)
    tloss.backward()
    topt.step()
    # embeddings, 2 per layer, transform_ln: each on [b * s, h] rows
    assert calls == ([(64, 128)] * 6 if route else [])

    tparams = dict(tm.named_parameters())
    grads = {n: (np.asarray(p.grad.value, np.float32), tparams[n].grad)
             for n, p in named if p.grad is not None}
    # token types are not given, so their table gets no gradient
    assert set(tparams) - set(grads) == \
        {"ernie.embeddings.token_type_embeddings.weight"}
    assert tparams["ernie.embeddings.token_type_embeddings.weight"].grad \
        is None
    if level == "O0":
        assert abs(float(tloss.detach()) - jloss) <= 1e-5 * abs(jloss)
        for n, (jg, tg) in grads.items():
            np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4, atol=1e-4,
                                       err_msg=n)
    else:
        assert tloss.dtype == torch.bfloat16
        assert abs(float(tloss.detach()) - jloss) <= 1e-2 * abs(jloss)
        for n, (jg, tg) in grads.items():
            assert tg.dtype == torch.float32, n
            den = np.linalg.norm(jg)
            if "k_proj.bias" in n:
                den = np.linalg.norm(grads[n.replace("k_proj",
                                                     "q_proj")][0])
            rel = np.linalg.norm(tg.numpy() - jg) / den
            assert rel <= 3e-2, (n, rel)
    if level == "O2":
        return
    for n, p in named:
        if "k_proj.bias" in n:
            continue
        step = np.asarray(p.value) - arrays[n]
        moved = tparams[n].detach().numpy() - arrays[n]
        assert np.abs(moved - step).max() <= 0.1 * LR, n


def test_ernie_tiny_takes_the_composed_route(ln_route):
    """h 64 fails ``h % 128 == 0``: with the flag on no LayerNorm goes to
    the kernel on either side, and the outputs agree."""
    set_route, calls = ln_route
    set_route(True)
    cfg = dict(vars(ERNIE_CONFIGS["ernie-tiny"]), hidden_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    assert vars(J_CONFIGS["ernie-tiny"]) == vars(ERNIE_CONFIGS["ernie-tiny"])
    jm, tm, _ = _pair(JPretraining, ErnieForPretraining, cfg, seed=5)
    ids, labels, ns, _ = _batch(2, cfg["vocab_size"])
    jloss = _loss(jm, ids, labels, ns, "O0", _j)
    tloss = _loss(tm, ids, labels, ns, "O0", _t)
    assert calls == []
    tloss = float(tloss.detach())
    assert abs(tloss - float(np.asarray(jloss.value))) <= 1e-5 * abs(tloss)


def test_configs_match_jax():
    assert set(ERNIE_CONFIGS) == set(J_CONFIGS)
    for name, cfg in ERNIE_CONFIGS.items():
        assert vars(cfg) == vars(J_CONFIGS[name]), name


@pytest.mark.parametrize("padding_idx", [None, 2, -1])
def test_embedding_matches_jax(padding_idx):
    """The default N(0, 1) table, and ``padding_idx``: a zero row at
    init that receives no gradient (the reference's lookup grad masks
    it). Same table and ids on both sides: same rows, same gradient."""
    pt.seed(1)
    jemb = JEmbedding(6, 4, padding_idx=padding_idx)
    table = np.array(jemb.weight.value)
    temb = Embedding(6, 4, padding_idx, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    if padding_idx is not None:
        assert not temb.weight[padding_idx].any()
        assert not table[padding_idx].any()
    with torch.no_grad():
        temb.weight.copy_(torch.from_numpy(table))
    ids = np.array([[0, 2, 5, 2], [5, 1, 2, 3]], np.int32)
    w = np.random.RandomState(0).randn(2, 4, 4).astype(np.float32)
    jout = jemb(_j(ids))
    (jout * _j(w)).sum().backward()
    tout = temb(_t(ids))
    (tout * _t(w)).sum().backward()
    np.testing.assert_array_equal(tout.detach().numpy(),
                                  np.asarray(jout.value))
    np.testing.assert_allclose(temb.weight.grad.numpy(),
                               np.asarray(jemb.weight.grad.value),
                               rtol=1e-6, atol=1e-6)
    if padding_idx is not None:
        assert not temb.weight.grad[padding_idx].any()


def test_linear_default_is_xavier_uniform():
    """Without ``std`` a Linear draws U(-l, l), ``l = sqrt(6 / (in +
    out))``, as the reference's XavierInitializer; the bias is zero."""
    lin = Linear(300, 100, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    limit = (6.0 / 400) ** 0.5
    w = lin.weight.detach()
    assert float(w.abs().max()) <= limit
    assert abs(float(w.std()) - limit / 3 ** 0.5) <= 0.02 * limit
    assert not lin.bias.any()
