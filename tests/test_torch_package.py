"""Package rules of the PyTorch port: it imports neither jax nor the JAX
package, its entry points refuse to run without a device when none is
named and no CUDA is present, CPU tensors never launch a kernel, and
its flags keep the JAX package's names and defaults."""

import ast
from pathlib import Path

import pytest
import torch

import paddle_tpu.flags as jflags
import paddle_tpu_torch
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flash_pack2 as fp2
from paddle_tpu_torch.ops.cuda import layer_norm as ln
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.serving import DisaggRouter, ReplicaRouter, ServingEngine
from paddle_tpu_torch.tools import loadgen

ROOT = Path(__file__).resolve().parents[1]
TINY = GPTConfig(vocab_size=97, max_position_embeddings=64, hidden_size=32,
                 num_layers=2, num_heads=4, ffn_hidden_size=64)


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            for alias in node.names:
                yield f"{node.module}.{alias.name}"


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "paddle_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "tools" / "torch_train_profile.py",
              ROOT / "tools" / "torch_trace_drops.py"]
    scanned = {str(f.relative_to(ROOT)) for f in files}
    for module in ("amp/auto_cast.py", "amp/lists.py", "optimizer.py",
                   "ops/optimizer_ops.py", "ops/cuda/flash_attention.py",
                   "ops/attention_ops.py", "nn/functional.py",
                   "ops/cuda/layer_norm.py", "ops/cuda/flash_pack2.py",
                   "nn/transformer.py", "models/ernie.py",
                   "tools/kernel_ab.py", "jit.py", "ops/cuda/adamw.py",
                   "models/generation.py", "serving/decoding.py",
                   "optimizer_lr.py", "amp/grad_scaler.py",
                   "vision/models.py", "vision/__init__.py", "prng.py",
                   "serving/router.py", "resilience/__init__.py",
                   "resilience/injector.py", "resilience/retry.py",
                   "observability/__init__.py", "observability/metrics.py",
                   "observability/runlog.py", "monitor.py",
                   "ops/cuda/_launches.py", "observability/tracing.py",
                   "tools/loadgen.py", "serving/lora.py",
                   "serving/kv_tier.py"):
        assert f"paddle_tpu_torch/{module}" in scanned, module
    bad = {(str(f.relative_to(ROOT)), root) for f in files
           for root in _imported_roots(f)
           if root in ("jax", "jaxlib", "paddle_tpu")}
    assert not bad, bad
    # the port's load generator is its own copy of tools/loadgen.py
    bad = {(str(f.relative_to(ROOT)), mod) for f in files
           for mod in _imported_modules(f)
           if mod == "tools.loadgen" or mod.startswith("tools.loadgen.")}
    assert not bad, bad


def test_entry_points_raise_without_a_device(monkeypatch):
    cpu_model = GPTForCausalLM(TINY, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        paddle_tpu_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPTForCausalLM(TINY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cpu_model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaRouter(cpu_model, n_replicas=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DisaggRouter(cpu_model, n_prefill=1, n_decode=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.main(["--model", "gpt2-tiny", "--disagg", "1x1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loadgen.main(["--model", "gpt2-tiny"])
    with pytest.raises(ValueError, match="generator"):
        GPTForCausalLM(TINY, device="meta", generator=torch.Generator())


def test_kernel_wrapper_runs_plain_only_on_cpu_and_raises_elsewhere():
    q = torch.zeros(1, 1, 1, 8)
    pool = torch.zeros(2, 1, 4, 8)
    tables = torch.zeros(1, 1, dtype=torch.int32)
    pos = torch.zeros(1, dtype=torch.int32)
    before = pa.launches
    out = pa.paged_attention(q, pool, pool, tables, pos)
    assert out.shape == q.shape and pa.launches == before
    meta = [t.to("meta") for t in (q, pool, pool, tables, pos)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        pa.paged_attention(*meta)
    with pytest.raises(ValueError, match="together"):
        pa.paged_attention(q, pool, pool, tables, pos,
                           k_scale=torch.zeros(2, 1))


def test_flash_wrappers_run_plain_only_on_cpu_and_raise_elsewhere():
    q = torch.randn(2, 32, 8)
    before = dict(fa.launches)
    o, lse = fa.flash_fwd(q, q, q, True, 0.5)
    delta = (o * o).sum(-1)
    dq = fa.flash_bwd_dq(q, q, q, o, lse, delta, True, 0.5)
    dk, dv = fa.flash_bwd_dkv(q, q, q, o, lse, delta, True, 0.5)
    assert o.shape == dq.shape == dk.shape == dv.shape == q.shape
    assert tuple(lse.shape) == (2, 32)
    assert fa.launches == before
    meta = q.to("meta")
    mstats = lse.to("meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_fwd(meta, meta, meta, True, 0.5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_bwd_dq(meta, meta, meta, meta, mstats, mstats, True, 0.5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_bwd_dkv(meta, meta, meta, meta, mstats, mstats, True, 0.5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(meta[None], meta[None], meta[None], causal=True)


def _ln_calls(x):
    g = torch.ones(x.shape[-1], device=x.device)
    stats = torch.zeros(x.shape[0], device=x.device)
    return [lambda: ln.ln_fwd(x, g, g, 1e-5),
            lambda: ln.ln_bwd(x, g, stats, stats + 1.0, x),
            lambda: ln.fused_layer_norm(x, g, g)]


def _pack2_calls(x):
    return [lambda: fp2.packed_flash_fwd(x, x, x, True, 0.5)]


@pytest.mark.parametrize("calls,shape", [(_ln_calls, (5, 8)),
                                         (_pack2_calls, (2, 16, 8))])
def test_new_wrappers_run_plain_only_on_cpu_and_raise_elsewhere(calls,
                                                                shape):
    """The LayerNorm and packed-heads wrappers: plain versions on CPU
    tensors, no launch counted; a ``meta`` tensor raises."""
    before = (dict(ln.launches), dict(fp2.launches))
    x = torch.randn(*shape)
    for call in calls(x):
        out = call()
        first = out[0] if isinstance(out, tuple) else out
        assert first.shape == x.shape and bool(torch.isfinite(first).all())
    assert (ln.launches, fp2.launches) == before
    for call in calls(x.to("meta")):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()


#: the flags of the replica fleet, the engine's thread, the resilience
#: plane and the run log (ported with the router)
FLEET_FLAGS = (
    "serving_idle_wait", "serving_dispatch_ahead", "serving_dispatch_threads",
    "serving_replicas", "serving_autoscale", "serving_replica_strikes",
    "serving_auto_restart", "serving_hedge_ms", "serving_hedge_budget",
    "serving_breaker_window", "serving_breaker_threshold",
    "serving_breaker_cooldown_s", "fault_spec", "fault_seed",
    "retry_max_attempts", "retry_base_delay", "retry_max_delay",
    "retry_deadline", "retry_budget_ratio", "retry_budget_reserve",
    "runlog_dir", "runlog_max_mb",
    # SLO admission, priorities and request tracing
    "serving_slo_ttft_ms", "serving_slo_prefill_ms", "serving_slo_tpot_ms",
    "serving_priority_preempt", "serving_trace", "serving_trace_keep",
    # the disaggregated fleet
    "serving_disagg", "serving_prefix_affinity", "serving_handoff_queue",
    # multi-tenant LoRA and the host KV tier, and the paged flag
    "serving_lora_rank", "serving_lora_max_adapters", "serving_host_tier",
    "serving_host_blocks", "serving_demote_idle_ms", "serving_paged")


def test_flags_keep_jax_names_and_defaults():
    ported = tflags.list_flags()
    jax_flags = jflags.list_flags()
    assert len(ported) == 55
    assert {"use_pallas_attention", "use_pallas_layer_norm", "pallas_min_seq",
            "pallas_flash_block_q", "pallas_flash_block_k",
            "serving_megastep", "serving_spec_tokens",
            "serving_spec_ngram"} <= set(ported)
    assert ported["serving_megastep"]["default"] == 1
    for name in ("serving_megastep", "serving_spec_tokens",
                 "serving_spec_ngram", *FLEET_FLAGS):
        assert ported[name]["help"] == jax_flags[name]["help"], name
    assert ported["use_pallas_layer_norm"]["default"] is False
    assert "CUDA" in ported["use_pallas_layer_norm"]["help"]
    for name, meta in ported.items():
        assert name in jax_flags, name
        if name == "serving_attn_impl":
            # documented value change: 'kernel'/'composed' replace
            # 'pallas'/'xla', and the kernel is the port's default
            assert meta["default"] == "kernel"
            assert jax_flags[name]["default"] == "xla"
            assert "'composed'" in meta["help"] and "'xla'" in meta["help"]
        else:
            assert meta["default"] == jax_flags[name]["default"], name
    with pytest.raises(ValueError, match="did you mean"):
        tflags.get_flag("serving_max_slot")
