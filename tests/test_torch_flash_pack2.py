"""The port's packed-heads flash forward against the TPU probe it replaces
(``tools/flash_pack2_bench.py``, loaded by path and run in Pallas
interpret mode) on the CPU: the head-pair packing and unpacking, and the
plain function the CUDA kernel computes, at b 1, h 4, s 128, d 64 with
64-row blocks, f32, causal or not.

Tolerance: 1e-5 (the sides differ in the order of summation and the
reference multiplies the block-diagonal zeros, which adds nothing); the
packing is a pure permutation and must agree exactly.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.cuda import flash_pack2 as tp2

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "flash_pack2_bench", ROOT / "tools" / "flash_pack2_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_the_pallas_probe(probe, causal):
    b, h, s, d = 1, 4, 128, 64
    scale = 1.0 / math.sqrt(d)
    rng = np.random.RandomState(11)
    qkv = [rng.randn(b, h, s, d).astype(np.float32) for _ in range(3)]
    jpacked = [probe.pack_pairs(jnp.asarray(a)) for a in qkv]
    tpacked = [tp2.pack_pairs(torch.from_numpy(a)) for a in qkv]
    for j, t in zip(jpacked, tpacked):
        assert tuple(t.shape) == (b * h // 2, s, 2 * d)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jo = probe.packed_flash_fwd(*jpacked, causal, scale, 64, 64)
    to = tp2.packed_flash_fwd(*tpacked, causal, scale)
    assert to.dtype == torch.float32 and to.shape == tpacked[0].shape
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    # the probe's own unpacking (its o_pk_un) against unpack_pairs
    jun = jnp.swapaxes(jo.reshape(b, h // 2, s, 2, d), 2, 3).reshape(
        b * h, s, d)
    np.testing.assert_allclose(tp2.unpack_pairs(to).numpy(), np.asarray(jun),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(tp2.unpack_pairs(tpacked[0]),
                       torch.from_numpy(qkv[0]).reshape(b * h, s, d))
