"""The port's ServingEngine against the JAX ServingEngine on the CPU:
identical output tokens for the same weights and prompts, with f32 and
int8 pools, the prefix cache on and off (a resubmitted prompt then
decodes from shared blocks or not), and the port's two attention paths
(the kernel module's plain version and the composed oracle) agreeing
with each other. The JAX side runs its composed read path
(``attn_impl`` 'xla'), which its own slow tests hold token-identical to
the Pallas kernel.
"""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import numpy as np
import pytest

import paddle_tpu as pt
from paddle_tpu.models.gpt import GPTConfig as JGPTConfig
from paddle_tpu.models.gpt import GPTForCausalLM as JGPT
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu_torch.models.convert import gpt_state_from_numpy
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.serving import (DecodeParams, QueueFullError,
                                      ServingEngine)

GEOM = dict(vocab_size=97, max_position_embeddings=64, hidden_size=32,
            num_layers=2, num_heads=4, ffn_hidden_size=64)
ENGINE = dict(max_slots=2, max_len=32, buckets=[8, 16], max_queue=16,
              block_size=4)


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


def _prompts(sizes, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 97, size=n).tolist() for n in sizes]


def _serve(eng, prompts, mnt=5):
    """Serve ``prompts``, then resubmit the longest one once the rest
    are done (a prefix-cache hit when the cache is on)."""
    reqs = [eng.submit(p, max_new_tokens=mnt) for p in prompts]
    eng.run_until_idle()
    reqs.append(eng.submit(max(prompts, key=len), max_new_tokens=mnt))
    eng.run_until_idle()
    assert all(r.state == "done" for r in reqs)
    return [r.output_ids for r in reqs]


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_engine_tokens_match_jax(models, kv_dtype, prefix_cache):
    jm, tm = models
    prompts = _prompts((3, 7, 5, 11))
    pt.set_flags({"serving_attn_impl": "xla"})
    ref = _serve(JServingEngine(jm, kv_dtype=kv_dtype,
                                prefix_cache=prefix_cache, **ENGINE),
                 prompts)
    before = pa.launches
    for impl in ("kernel", "composed"):
        eng = ServingEngine(tm, kv_dtype=kv_dtype, prefix_cache=prefix_cache,
                            attn_impl=impl, device="cpu", **ENGINE)
        assert _serve(eng, prompts) == ref, impl
        st = eng.stats()
        assert st["attn_impl"] == impl and st["kv_dtype"] == kv_dtype
        assert st["completed"] == 5 and st["active"] == 0
        assert st["prefix_hit_requests"] == (1 if prefix_cache else 0)
        # every block but the trash block (and cached prefixes) is back
        assert st["kv_blocks_used"] == 1 + st["prefix_entries"]
        if kv_dtype == "int8":
            assert 0.0 < st["kv_quant_max_abs_err"] < 0.5
    assert pa.launches == before      # CPU tensors never launch


def test_engine_stop_eos_and_admission(models):
    _, tm = models
    eng = ServingEngine(tm, attn_impl="kernel", device="cpu", **ENGINE)
    base = eng.submit([5, 6, 7], max_new_tokens=6)
    eng.run_until_idle()
    gen = base.tokens
    eos = eng.submit([5, 6, 7], max_new_tokens=6, eos_token_id=gen[2])
    stop = eng.submit([5, 6, 7], max_new_tokens=6, stop=[gen[1:3]])
    eng.run_until_idle()
    assert eos.tokens == gen[:gen.index(gen[2]) + 1]
    first_stop = next(i for i in range(1, 6) if gen[i - 1:i + 1] == gen[1:3])
    assert stop.tokens == gen[:first_stop + 1]
    assert eng.results() == [base, eos, stop]
    assert base.ttft is not None and base.tpot is not None
    # sampled requests serve (tests/test_torch_sampling.py holds their
    # tokens to the JAX engine's); JSON mode needs a grammar, as in the
    # reference (tests/test_torch_json_grammar.py)
    sampled = eng.submit([1, 2], max_new_tokens=6, temperature=0.7, seed=3)
    eng.run_until_idle()
    assert sampled.done and len(sampled.tokens) == 6
    with pytest.raises(ValueError, match="grammar"):
        eng.submit([1, 2], decode=DecodeParams(json_mode=True))
    with pytest.raises(ValueError):
        eng.submit([1, 200])                 # outside the vocabulary
    with pytest.raises(ValueError):
        eng.submit(list(range(1, 30)), max_new_tokens=8)   # > max_len
    small = ServingEngine(tm, device="cpu", **{**ENGINE, "max_queue": 1})
    small.submit([1, 2], max_new_tokens=4)
    with pytest.raises(QueueFullError):
        small.submit([1, 2], max_new_tokens=4)
    with pytest.raises(ValueError):
        ServingEngine(tm, attn_impl="pallas", device="cpu", **ENGINE)
