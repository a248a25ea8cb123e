"""O2's rounding points in the port's vision layers against the JAX
package's on the CPU, one block at a time: ResNet's stem (conv 7 x 7 / 2,
BatchNorm2D, ReLU, max pool), a BasicBlock and a BottleneckBlock, each
with a strided downsample, from the same numpy weights and inputs.

At batch 4 and 16 x 16 each BatchNorm normalizes at least 256 values per
channel, so bf16 rounding noise does not swamp the signal as it does in a
whole ResNet at batch 2 (``tests/test_torch_vision.py:resnet_step_case``).
Both packages cast at the same places (convolutions take bf16, batch norm
takes f32, the rest runs in bf16 under O2) and round alike, so the port's
O2 results (the output, the input's gradient, every parameter's gradient
and every running statistic) lie within 1e-4 (relative Frobenius) of
JAX's O2 results; they lie within 1.2e-6 here. Each sublayer's output
dtype equals JAX's. The control: the port run at O0 lies 1.7e-3 or more
import torch_threads  # noqa: F401  (one worker's share of the cores)
from JAX's O2 output, gradients and running means, and so fails that
bound (the running variances move less than 1e-4 between f32 and bf16,
so they are no control).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu import amp as jamp
from paddle_tpu.dygraph.layers import Sequential as JSequential
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu.nn import layers_common as JL
from paddle_tpu.vision import models as jvm
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.models.convert import state_from_numpy
from paddle_tpu_torch.nn import layers_common as TL
from paddle_tpu_torch.vision import models as tvm

O2_TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jax_block(name):
    """The JAX block and its input's shape."""
    if name == "stem":
        return JSequential(
            JL.Conv2D(3, 16, 7, stride=2, padding=3, bias_attr=False),
            JL.BatchNorm2D(16), JL.ReLU(),
            JL.MaxPool2D(3, 2, padding=1)), (4, 3, 32, 32)
    down = JSequential(JL.Conv2D(16, 32, 1, stride=2, bias_attr=False),
                       JL.BatchNorm2D(32))
    if name == "basic":
        return jvm.BasicBlock(16, 32, 2, down), (4, 16, 16, 16)
    return jvm.BottleneckBlock(16, 8, 2, down), (4, 16, 16, 16)


def _port_block(name):
    kw = dict(device="cpu", generator=torch.Generator().manual_seed(0))
    if name == "stem":
        return torch.nn.Sequential(
            TL.Conv2D(3, 16, 7, stride=2, padding=3, bias_attr=False, **kw),
            TL.BatchNorm2D(16, device="cpu"), TL.ReLU(),
            TL.MaxPool2D(3, 2, padding=1))
    down = torch.nn.Sequential(
        TL.Conv2D(16, 32, 1, stride=2, bias_attr=False, **kw),
        TL.BatchNorm2D(32, device="cpu"))
    if name == "basic":
        return tvm.BasicBlock(16, 32, 2, down, **kw)
    return tvm.BottleneckBlock(16, 8, 2, down, **kw)


def _jax_run(name, x, r):
    """JAX's block at O2, eagerly: output, gradients (of ``sum(out * r)``)
    and running statistics as numpy, and each sublayer's output dtype."""
    pt.seed(1)
    jm, _ = _jax_block(name)
    state = {k: np.asarray(v.value) for k, v in jm.state_dict().items()}
    dtypes = {}
    for n, sub in jm.named_sublayers():
        sub.register_forward_post_hook(
            lambda layer, args, out, n=n: dtypes.__setitem__(
                n, str(out.value.dtype)))
    xs = Tensor(jnp.asarray(x), stop_gradient=False)
    with jamp.auto_cast(enable=True, level="O2"):
        out = jm(xs)
    (out.astype("float32") * Tensor(jnp.asarray(r))).sum().backward()
    res = {"out": np.asarray(out.value, np.float32),
           "x.grad": np.asarray(xs.grad.value)}
    res.update({n: np.asarray(p.grad.value)
                for n, p in jm.named_parameters()})
    res.update({n: np.asarray(v.value) for n, v in jm.state_dict().items()
                if n.endswith(("._mean", "._variance"))})
    return state, res, dtypes


def _port_run(name, state, x, r, level):
    tm = _port_block(name)
    tm.load_state_dict(state_from_numpy(state, "cpu"), strict=True)
    dtypes = {}
    for n, sub in tm.named_modules():
        if n:
            sub.register_forward_hook(
                lambda mod, args, out, n=n: dtypes.__setitem__(
                    n, str(out.dtype).replace("torch.", "")))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    with tamp.auto_cast(enable=level == "O2", level="O2"):
        out = tm(xt)
    (out.float() * torch.from_numpy(r)).sum().backward()
    res = {"out": out.detach().float().numpy(), "x.grad": xt.grad.numpy()}
    res.update({n: p.grad.numpy() for n, p in tm.named_parameters()})
    res.update({n: b.numpy() for n, b in tm.named_buffers()})
    return res, dtypes


@pytest.mark.parametrize("name", ["stem", "basic", "bottleneck"])
def test_o2_block_matches_jax(name):
    _, shape = _jax_block(name)
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    with torch.no_grad():
        out_shape = _port_block(name).eval()(torch.from_numpy(x)).shape
    r = np.random.RandomState(3).randn(*out_shape).astype(np.float32)
    state, want, jdtypes = _jax_run(name, x, r)
    got, tdtypes = _port_run(name, state, x, r, "O2")

    assert tdtypes == jdtypes
    convs = [n for n, m in _port_block(name).named_modules()
             if isinstance(m, TL.Conv2D)]
    norms = [n for n, m in _port_block(name).named_modules()
             if isinstance(m, TL.BatchNorm2D)]
    assert convs and norms
    assert all(tdtypes[n] == "bfloat16" for n in convs), tdtypes
    assert all(tdtypes[n] == "float32" for n in norms), tdtypes
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert _rel(got[k], want[k]) <= O2_TOL, (k, _rel(got[k], want[k]))

    # the control: in f32 the port misses the bound on the output, every
    # gradient and every running mean
    f32, _ = _port_run(name, state, x, r, "O0")
    for k in want:
        if not k.endswith("._variance"):
            assert _rel(f32[k], want[k]) > O2_TOL, (
                k, _rel(f32[k], want[k]))
