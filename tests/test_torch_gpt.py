"""The port's GPT against the JAX model on the CPU, with the weights
carried across by ``gpt_state_from_numpy``: the no-cache logits, and
the paged-cache prefill + decode logits for f32, bf16 and int8 pools
(the oracle read path on the JAX side, both read paths on the port's),
all within 1e-5 in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.dygraph.tape import no_grad
from paddle_tpu.dygraph.tensor import Tensor
from paddle_tpu.models.generation import _unwrap_pools, _wrap_pools
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64)
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    pt.seed(7)
    jm = JGPT(JGPTConfig(**GEOM))
    jm.eval()
    arrays = {n: np.asarray(p.value) for n, p in jm.named_parameters()}
    tm = GPTForCausalLM(GPTConfig(**GEOM), device="cpu")
    tm.load_state_dict(gpt_state_from_numpy(arrays, "cpu"), strict=True)
    tm.eval()
    return jm, tm


def test_weights_carry_across_by_name(models):
    jm, tm = models
    names = {n for n, _ in jm.named_parameters()}
    assert names == set(tm.state_dict())
    assert tuple(tm.gpt.blocks[0].attn.qkv_proj.weight.shape) == (32, 96)


def test_no_cache_logits_match(models):
    jm, tm = models
    ids = np.random.RandomState(0).randint(0, 97, size=(2, 11))
    with no_grad():
        ref = jm(Tensor(ids.astype(np.int32), stop_gradient=True)).numpy()
    with torch.no_grad():
        out = tm(torch.from_numpy(ids)).numpy()
    assert out.shape == (2, 11, 97)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)


def _jax_paged(jm, pools, ids, pos, tables):
    with no_grad():
        logits, newp = jm(Tensor(ids.astype(np.int32), stop_gradient=True),
                          cache=_wrap_pools(pools), cache_pos=pos,
                          block_tables=tables)
    pools, _ = _unwrap_pools(newp)
    return logits.numpy(), pools


def _torch_paged(tm, pools, ids, pos, tables, impl):
    with torch.no_grad():
        logits, newp = tm(torch.from_numpy(ids), cache=pools,
                          cache_pos=torch.from_numpy(pos),
                          block_tables=torch.from_numpy(tables),
                          attn_impl=impl)
    return logits.numpy(), [tuple(layer[:4]) for layer in newp]


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_paged_prefill_and_decode_logits_match(models, kv_dtype):
    """Bucketed prefill of two prompts (lengths 6 and 3, padded to 8)
    then two decode steps; logits compared at every real position."""
    jm, tm = models
    rng = np.random.RandomState(1)
    lens = [6, 3]
    ids = np.zeros((2, 8), np.int64)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.randint(0, 97, size=n)
    # blocks of 4; each row owns 3 blocks, table padding -> trash 0
    tables = np.asarray([[1, 2, 3, 0], [4, 5, 6, 0]], np.int32)
    pos = np.zeros(2, np.int32)
    jpools = [tuple(t.value for t in layer)
              for layer in jm.gpt.gen_block_pool(7, 4, kv_dtype)]
    ref, jpools = _jax_paged(jm, jpools, ids, jnp.asarray(pos),
                             jnp.asarray(tables))
    outs = {}
    for impl in ("kernel", "composed"):
        tpools = tm.gpt.gen_block_pool(7, 4, kv_dtype)
        out, tpools = _torch_paged(tm, tpools, ids, pos, tables, impl)
        for i, n in enumerate(lens):
            np.testing.assert_allclose(out[i, :n], ref[i, :n], atol=ATOL,
                                       rtol=0)
        outs[impl] = tpools
    steps = [np.asarray(lens, np.int32), np.asarray(lens, np.int32) + 1]
    for p in steps:
        tok = rng.randint(0, 97, size=(2, 1))
        ref, jpools = _jax_paged(jm, jpools, tok, jnp.asarray(p),
                                 jnp.asarray(tables))
        for impl in ("kernel", "composed"):
            out, outs[impl] = _torch_paged(tm, outs[impl], tok, p, tables,
                                           impl)
            np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
