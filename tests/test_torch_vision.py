"""The port's vision surface (``nn/functional.py`` conv2d, the pools and
batch_norm; the layers of ``nn/layers_common.py``; ``vision/models.py``)
against the JAX package's on the CPU, from the same numpy inputs and
weights (``models/convert.py:state_from_numpy``).

Tolerances (relative Frobenius): f32 (O0) forward outputs within 1e-5
and gradients of the conv/pool stack within 1e-4 (sums over the batch
and the filter taps run in another order than XLA's); BatchNorm's
running statistics within 1e-6. ResNet steps at O0: logits, loss and BN
buffers within 1e-5, the median gradient within 1e-4 and each within
5e-2 (BatchNorm over eight values per channel in layer4 amplifies the
rounding of a few bias and scale gradients); after the step each side's
parameters are ``p - 0.1 g`` of its own gradient within 1e-6. O2 (bf16
convolutions, pools, adds and ReLUs; f32 batch norm, as both packages
cast) rounds to bf16 at every layer, and at batch
2 that noise grows through the depth: each result (logits, loss, every
gradient, every BN buffer) is held to twice the distance of JAX's own O2
result from its f32 one, plus 1e-3: the port's bf16 result lies about
as far from the f32 one as JAX's, in another direction (see
:func:`resnet_step_case`). That bound tells O2 from f32 in no result,
so the whole-model O2 step holds only that it runs and that every
sublayer's output dtype is JAX's; ``tests/test_torch_vision_o2.py``
holds O2's rounding to 1e-4 block by block, where BatchNorm is stable.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu import jit as jjit
from paddle_tpu import optimizer as jopt
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu.nn import functional as JF
from paddle_tpu.nn import layers_common as JL
from paddle_tpu.vision import models as jvm
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import layers_common as TL
from paddle_tpu_torch.vision import models as tvm


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _j(a, grad=False):
    return Tensor(jnp.asarray(a), stop_gradient=not grad)


def _tt(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def test_conv_pool_stack_matches_jax():
    """conv2d with groups and dilation, with a bias and an explicit
    [ph0, ph1, pw0, pw1] padding, then max pool (padded), exclusive average
    pool (padded) and the adaptive pools (1 x 1 and 3 x 7 from 6 x 7):
    forward and
    the gradients of the input, filters and bias."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 13, 12).astype(np.float32)
    w1 = (rng.randn(6, 2, 3, 3) * 0.3).astype(np.float32)
    b1 = rng.randn(6).astype(np.float32)
    w2 = (rng.randn(8, 6, 3, 3) * 0.3).astype(np.float32)

    def run(F, mk):
        xs, a, b, c = mk(x, True), mk(w1, True), mk(b1, True), mk(w2, True)
        h = F.conv2d(xs, a, b, stride=1, padding=1, dilation=2, groups=2)
        h = F.conv2d(h, c, None, stride=2, padding=[1, 0, 2, 1])
        m = F.max_pool2d(h, 3, 2, padding=1)
        v = F.avg_pool2d(h, 2, 1, padding=1, exclusive=True)
        outs = [h, m, v, F.adaptive_avg_pool2d(h, 1),
                F.adaptive_avg_pool2d(v, [3, 7])]
        total = sum((o * o).sum() for o in outs[1:])
        total.backward()
        return outs, [xs, a, b, c]

    jouts, jins = run(JF, _j)
    touts, tins = run(TF, _tt)
    for jo, to in zip(jouts, touts):
        assert tuple(to.shape) == tuple(jo.value.shape)
        assert _rel(to.detach().numpy(), jo.value) < 1e-5
    for ji, ti in zip(jins, tins):
        assert _rel(ti.grad.numpy(), ji.grad.value) < 1e-4


def test_batch_norm_running_statistics_over_two_steps():
    """Train-mode BatchNorm2D on two batches: outputs and the running
    mean and variance (the reference's momentum 0.9 on the running value,
    the biased batch variance) equal JAX's; torch's own update (the batch
    weighted by ``momentum``, the unbiased variance) would not, and the
    port's results are far from it. Then eval mode normalizes with the
    running statistics."""
    rng = np.random.RandomState(1)
    xs = [(rng.randn(3, 5, 4, 4) * 2 + 1).astype(np.float32)
          for _ in range(2)]
    jbn = JL.BatchNorm2D(5)
    tbn = TL.BatchNorm2D(5, device="cpu")
    torch_mean, torch_var = torch.zeros(5), torch.ones(5)
    for x in xs:
        jy = jbn(_j(x))
        ty = tbn(torch.from_numpy(x))
        assert _rel(ty.detach().numpy(), jy.value) < 1e-5
        for name in ("_mean", "_variance"):
            assert _rel(getattr(tbn, name).numpy(),
                        getattr(jbn, name).value) < 1e-6, name
        torch.nn.functional.batch_norm(torch.from_numpy(x), torch_mean,
                                       torch_var, training=True,
                                       momentum=0.9)
    assert _rel(torch_var.numpy(), tbn._variance.numpy()) > 0.3
    assert _rel(torch_mean.numpy(), tbn._mean.numpy()) > 0.3
    jbn.eval()
    tbn.eval()
    jy, ty = jbn(_j(xs[0])), tbn(torch.from_numpy(xs[0]))
    assert _rel(ty.detach().numpy(), jy.value) < 1e-5
    assert [n for n, _ in tbn.named_buffers()] == ["_mean", "_variance"]


def test_lenet_forward_matches_jax():
    pt.seed(3)
    jm = jvm.LeNet()
    tm = tvm.LeNet(device="cpu")
    tm.load_state_dict(state_from_numpy(
        {k: np.asarray(v.value) for k, v in jm.state_dict().items()},
        "cpu"), strict=True)
    x = np.random.RandomState(3).randn(2, 1, 28, 28).astype(np.float32)
    assert _rel(tm(torch.from_numpy(x)).detach().numpy(),
                jm(_j(x)).value) < 1e-5


MODELS = {"resnet18": lambda m: m.resnet18(num_classes=10),
          "bottleneck-1111": lambda m: m.ResNet(m.BottleneckBlock,
                                                [1, 1, 1, 1],
                                                num_classes=10)}


def _train_one(model, opt, x, labels, level, dtypes):
    """The port's forward (under ``auto_cast`` at O2), clear, backward;
    each sublayer's output dtype goes into ``dtypes``."""
    for n, sub in model.named_modules():
        if n:
            sub.register_forward_hook(
                lambda mod, args, out, n=n: dtypes.__setitem__(
                    n, str(out.dtype).replace("torch.", "")))
    with tamp.auto_cast(enable=level == "O2", level="O2"):
        logits = model(torch.from_numpy(x))
        loss = TL.CrossEntropyLoss()(logits, torch.from_numpy(labels))
    opt.clear_grad()
    loss.backward()
    return logits, loss


_JAX_RUNS = {}


def _jax_run(arch, level):
    """The JAX model's step at ``level`` from seed 5's weights, once per
    (arch, level) in this module, through ``jit.to_static`` as
    ``bench.py`` runs it (one XLA compile of the whole step; op by op
    the dygraph tape compiles ~320 ops for ~20 s): its initial state,
    logits, loss, gradients, BN buffers after the forward and parameters
    after the Momentum step, as numpy."""
    key = (arch, level)
    if key not in _JAX_RUNS:
        pt.seed(5)
        jm = MODELS[arch](jvm)
        state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
        jo = jopt.Momentum(learning_rate=0.1, momentum=0.9,
                           parameters=jm.parameters())
        dtypes = {}
        for n, sub in jm.named_sublayers():
            sub.register_forward_post_hook(
                lambda layer, args, out, n=n: dtypes.__setitem__(
                    n, str(out.value.dtype)))
        x, labels = _batch()
        ce = JL.CrossEntropyLoss()

        def step(xb, lb):
            with jamp.auto_cast(enable=level == "O2", level="O2"):
                logits = jm(xb)
                loss = ce(logits, lb)
            jm.clear_gradients()
            loss.backward()
            grads = [p.grad for p in jm.parameters()]
            buffers = [v for n, v in jm.state_dict().items() if "._" in n]
            jo.step()
            return logits, loss, grads, buffers

        jl, jloss, jgrads, jbufs = jjit.to_static(
            step, layers=[jm], optimizers=[jo])(x, labels)
        grads = {n: np.asarray(g.value)
                 for (n, _), g in zip(jm.named_parameters(), jgrads)}
        buffers = {n: np.asarray(b.value) for n, b in zip(
            [n for n in jm.state_dict() if "._" in n], jbufs)}
        _JAX_RUNS[key] = dict(
            state=state, logits=jl.value, loss=float(jloss.value),
            grads=grads, buffers=buffers,
            params={n: np.asarray(p.value)
                    for n, p in jm.named_parameters()},
            names=[n for n, _ in jm.named_parameters()], dtypes=dtypes)
    return _JAX_RUNS[key]


def _batch():
    rng = np.random.RandomState(6)
    return (rng.randn(2, 3, 64, 64).astype(np.float32),
            rng.randint(0, 10, (2,)).astype(np.int64))


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_bottleneck_resnet_step_matches_jax(level):
    """:func:`resnet_step_case` on the BottleneckBlock ResNet [1, 1, 1, 1]
    (``tests/test_torch_resnet.py`` runs resnet18: each JAX model's first
    step compiles ~320 ops for ~20 s, so the two share no file)."""
    resnet_step_case("bottleneck-1111", level)


def resnet_step_case(arch, level):
    """One train step on 2 x 3 x 64 x 64 (Momentum 0.1/0.9, bench.py's
    optimizer): logits and loss, every gradient, the BN buffers after the
    forward and the parameters after the update.

    Not 32 x 32: there layer4 runs at 1 x 1, its BatchNorm normalizes two
    values per channel, and the f32 logits alone move 3.8e-4 (relative)
    from a float64 run of the same model (2.7e-6 at 64 x 64). At O2 the
    JAX package's own bf16 gradients lie 20-90% (relative Frobenius) from
    its f32 ones at this batch, and its logits, loss and BN buffers
    0.3-3%: each of the port's results is held to twice that distance
    from JAX's, plus 1e-3."""
    ref = _jax_run(arch, level)
    ctor = {"resnet18": lambda: tvm.resnet18(num_classes=10, device="cpu"),
            "bottleneck-1111": lambda: tvm.ResNet(
                tvm.BottleneckBlock, [1, 1, 1, 1], num_classes=10,
                device="cpu")}[arch]
    tm = ctor()
    state = ref["state"]
    tm.load_state_dict(state_from_numpy(state, "cpu"), strict=True)
    assert [n for n, _ in tm.named_parameters()] == ref["names"]
    to = topt.Momentum(learning_rate=0.1, momentum=0.9,
                       parameters=tm.named_parameters())
    x, labels = _batch()
    dtypes = {}
    tl, tloss = _train_one(tm, to, x, labels, level, dtypes)
    assert dtypes == ref["dtypes"]
    o2 = level == "O2"
    f32 = _jax_run(arch, "O0") if o2 else None

    def held(got, want, name, f32_want=None, tol=1e-5):
        """O0: within ``tol``; O2: within twice the distance of JAX's
        own bf16 result from its f32 one, plus 1e-3 (the port's bf16
        result lies about as far from the f32 one, on another side)."""
        gap = _rel(got, want)
        bound = (2 * _rel(want, f32_want) + 1e-3) if o2 else tol
        assert gap <= bound, (name, gap, bound)
        return gap

    assert str(tl.dtype).replace("torch.", "") == str(ref["logits"].dtype)
    held(tl.detach().float().numpy(), np.asarray(ref["logits"], np.float32),
         "logits", o2 and np.asarray(f32["logits"], np.float32))
    held(float(tloss), ref["loss"], "loss", o2 and f32["loss"])
    jg = ref["grads"]
    tg = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    gaps = {n: held(tg[n], jg[n], n, o2 and f32["grads"][n], tol=5e-2)
            for n in jg}
    if not o2:
        assert np.median(list(gaps.values())) < 1e-4
    buffers = dict(tm.named_buffers())
    assert set(buffers) == set(ref["buffers"])
    for n, b in buffers.items():
        held(b.numpy(), ref["buffers"][n], n, o2 and f32["buffers"][n])
    to.step()
    # Momentum's first step is p - lr * g on each side (the gradients were
    # held above; at lr 0.1 they move the weights more than the weights'
    # own size, so the update is held to each side's own gradient)
    lr = np.float32(0.1)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   state[n] - lr * tg[n], rtol=0,
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(ref["params"][n], state[n] - lr * jg[n],
                                   rtol=0, atol=1e-6, err_msg=n)


def test_models_need_a_device_or_the_card(monkeypatch):
    """The vision models are entry points: with no ``device`` they take
    the card, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for ctor in (tvm.LeNet, tvm.resnet18):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ctor()
    assert next(tvm.LeNet(device="cpu").parameters()).device.type == "cpu"


def test_nhwc_conv_and_batch_norm_match_jax():
    """``data_format="NHWC"``: the filter stays OIHW, the bias and the
    batch statistics go over the last axis, as in the reference."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 6, 5, 4).astype(np.float32)
    w = (rng.randn(3, 4, 3, 3) * 0.3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    jy = JF.conv2d(_j(x), _j(w), _j(b), padding=1, data_format="NHWC")
    ty = TF.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                   torch.from_numpy(b), padding=1, data_format="NHWC")
    assert tuple(ty.shape) == tuple(jy.value.shape) == (2, 6, 5, 3)
    assert _rel(ty.numpy(), jy.value) < 1e-5
    jbn = JL.BatchNorm2D(3, data_format="NHWC")
    tbn = TL.BatchNorm2D(3, data_format="NHWC", device="cpu")
    jo, to = jbn(jy), tbn(ty)
    assert _rel(to.detach().numpy(), jo.value) < 1e-5
    assert _rel(tbn._variance.numpy(), jbn._variance.value) < 1e-6
