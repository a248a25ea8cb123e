"""The port's CTR models (``models/ctr.py``: ``WideDeep``, ``DeepFM``)
against the JAX package's on the CPU, weights carried across by name:
the forward over one-hot and multi-hot (0-padded) slot ids, the
gradient of every parameter, and one SGD step. Held to 1e-5 absolute
and relative."""

import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu.models import ctr as jctr
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu_torch.models import ctr as tctr
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.optimizer import SGD

TOL = dict(rtol=1e-5, atol=1e-5)
GEOM = dict(vocab_size=60, embed_dim=4, num_slots=3, hidden_sizes=(8, 5))


@pytest.mark.parametrize("hot", [1, 3])
@pytest.mark.parametrize("name", ["WideDeep", "DeepFM"])
def test_ctr_model_matches_jax(name, hot):
    pt.seed(5)
    jm = getattr(jctr, name)(**GEOM)
    tm = getattr(tctr, name)(**GEOM, device="cpu")
    assert [n for n, _ in tm.named_parameters()] == \
        [n for n, _ in jm.named_parameters()]
    tm.load_state_dict(layer_state_from_numpy(
        {n: np.asarray(p.value) for n, p in jm.named_parameters()}, "cpu"))
    rng = np.random.RandomState(hot)
    shape = (6, 3) if hot == 1 else (6, 3, hot)
    ids = rng.randint(0, GEOM["vocab_size"], shape).astype(np.int64)
    ids.reshape(-1)[::4] = 0                     # padding ids
    y = rng.randint(0, 2, (6, 1)).astype(np.float32)
    jopt = JSGD(learning_rate=0.5, parameters=jm.parameters())
    topt = SGD(learning_rate=0.5, parameters=tm.named_parameters())
    jout = jm(Tensor(ids))
    tout = tm(torch.from_numpy(ids))
    np.testing.assert_allclose(tout.detach().numpy(),
                               np.asarray(jout.value), **TOL)
    jl = pt.nn.functional.binary_cross_entropy_with_logits(
        jout, Tensor(y))
    tl = torch.nn.functional.binary_cross_entropy_with_logits(
        tout, torch.from_numpy(y))
    np.testing.assert_allclose(float(tl.detach()),
                               float(np.asarray(jl.value)),
                               **TOL)
    jl.backward()
    tl.backward()
    tp = dict(tm.named_parameters())
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(tp[n].grad.numpy(),
                                   np.asarray(p.grad.value), err_msg=n,
                                   **TOL)
    jopt.step()
    topt.step()
    for n, p in jm.named_parameters():
        np.testing.assert_allclose(tp[n].detach().numpy(),
                                   np.asarray(p.value), err_msg=n, **TOL)
