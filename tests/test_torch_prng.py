"""The port's threefry streams (``paddle_tpu_torch/prng.py``) against
``jax.random`` on the CPU, with ``jax_threefry_partitionable`` on (JAX's
default) and 64-bit types off (JAX's default, and how the JAX package
runs outside this test harness, whose conftest turns them on): the
hash, ``PRNGKey`` (seeds past 32 bits and negative ones included),
``split`` and the random bits bit-equal; ``uniform`` bit-equal; ``gumbel`` within one ulp per logarithm (torch's and XLA's
``log`` may each round either way); ``categorical`` the same tokens."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch import prng

SEEDS = [0, 7, 2 ** 31 - 1, 2 ** 32 + 5, -3]


@pytest.fixture(autouse=True)
def jax_without_x64():
    with jax.enable_x64(False):
        yield


def _ulps(a, b):
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_partitionable_threefry_is_the_default():
    assert jax.config.jax_threefry_partitionable


def test_golden_vectors():
    assert prng.PRNGKey(7).tolist() == [0, 7]
    assert prng.split(prng.PRNGKey(7), 2).tolist() == \
        [[3625411723, 1954958720], [195045567, 4062205631]]


def test_threefry2x32_matches_jax():
    from jax._src.prng import threefry_2x32
    rng = np.random.RandomState(0)
    for _ in range(5):
        key = rng.randint(0, 2 ** 32, size=2, dtype=np.uint64).astype(
            np.uint32)
        count = rng.randint(0, 2 ** 32, size=64, dtype=np.uint64).astype(
            np.uint32)
        want = np.asarray(threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
        # threefry_2x32 hashes the count's two halves as the pairs
        a, b = prng.threefry2x32(int(key[0]), int(key[1]),
                                 torch.from_numpy(count[:32].astype(np.int64)),
                                 torch.from_numpy(count[32:].astype(np.int64)))
        np.testing.assert_array_equal(torch.cat([a, b]).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_match_jax(seed):
    jk = jax.random.PRNGKey(seed)
    tk = prng.PRNGKey(seed)
    assert tk.dtype == torch.int64
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    for n in (2, 2 * 4 + 2, 2 * 1 + 2):       # split(k, 2) and 2(K+1)
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      np.asarray(jax.random.split(jk, n)))
    with pytest.raises(OverflowError):
        prng.PRNGKey(2 ** 64)


def test_batched_keys_draw_as_vmap_does():
    keys = jax.random.split(jax.random.PRNGKey(11), 6)
    tkeys = torch.from_numpy(np.asarray(keys).astype(np.int64))
    np.testing.assert_array_equal(
        prng.split(tkeys, 3).numpy(),
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 3))(keys)))
    np.testing.assert_array_equal(
        prng.uniform(tkeys).numpy(),
        np.asarray(jax.vmap(jax.random.uniform)(keys)))
    np.testing.assert_array_equal(
        prng.uniform(tkeys.reshape(2, 3, 2)).numpy(),
        np.asarray(jax.vmap(jax.vmap(jax.random.uniform))(
            keys.reshape(2, 3, 2))))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_match_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    for shape in ((3, 97), (50,), ()):
        np.testing.assert_array_equal(
            prng.random_bits(tk, shape).numpy(),
            np.asarray(jax.random.bits(jk, shape)).astype(np.int64))
        u = prng.uniform(tk, shape)
        assert u.dtype == torch.float32
        np.testing.assert_array_equal(
            u.numpy(), np.asarray(jax.random.uniform(jk, shape)))
    tiny = float(np.finfo(np.float32).tiny)
    np.testing.assert_array_equal(
        prng.uniform(tk, (3, 97), minval=tiny).numpy(),
        np.asarray(jax.random.uniform(jk, (3, 97), minval=tiny)))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_one_ulp_per_log(seed):
    """``gumbel = -log(-log(u))`` with ``u`` bit-equal: each logarithm,
    fed the same input on both sides, within 1 ulp of JAX's; the
    composed value within 1 ulp of its magnitude plus the inner log's
    ulp carried through the outer one (a relative 2^-23 of the inner
    value is an absolute 2^-23 after the log; bounded by 2^-22)."""
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    want = np.asarray(jax.random.gumbel(jk, (3, 97)))
    got = prng.gumbel(tk, (3, 97)).numpy()
    tiny = float(np.finfo(np.float32).tiny)
    u = prng.uniform(tk, (3, 97), minval=tiny)
    inner_t = -torch.log(u)
    inner_j = -jnp.log(jnp.asarray(u.numpy()))
    assert _ulps(inner_t.numpy(), np.asarray(inner_j)).max() <= 1
    outer_t = -torch.log(inner_t).numpy()
    outer_j = np.asarray(-jnp.log(jnp.asarray(inner_t.numpy())))
    assert _ulps(outer_t, outer_j).max() <= 1
    np.testing.assert_array_equal(got, outer_t)
    bound = np.spacing(np.abs(want)) + 2.0 ** -22
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_categorical_matches_jax(seed):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(16, 300) * 2).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), 16)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys,
                                                       jnp.asarray(logits)))
    got = prng.categorical(torch.from_numpy(np.asarray(keys).astype(np.int64)),
                           torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)
