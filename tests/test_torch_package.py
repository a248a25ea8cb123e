"""Package rules of the PyTorch port: it imports neither jax nor the JAX
package, its entry points refuse to run without a device when none is
named and no CUDA is present, CPU tensors never launch a kernel, and
its flags keep the JAX package's names and defaults."""

import ast
import importlib
import inspect
import pkgutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.flags as jflags
from paddle_tpu.dygraph.tensor import Tensor as JTensor
from paddle_tpu.nn import functional as JF
import paddle_tpu_torch
from paddle_tpu_torch import dataset as tdataset
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import framework_io as tio
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.models import generation as tgen
from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn import layers_common as TL
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flash_pack2 as fp2
from paddle_tpu_torch.ops.cuda import layer_norm as ln
from paddle_tpu_torch.ops.cuda import paged_attention as pa
from paddle_tpu_torch.serving import DisaggRouter, ReplicaRouter, ServingEngine
from paddle_tpu_torch.serving import kv_cache as tkv
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
                   "serving/kv_tier.py", "observability/devprof.py",
                   "observability/compile_tracker.py",
                   "tools/perf_ledger.py", "tools/perf_regress.py",
                   "analysis/__init__.py", "analysis/concurrency.py",
                   "analysis/lifecycle.py", "analysis/recompile.py",
                   "tools/soak.py", "tools/lint_serving.py",
                   "nn/__init__.py", "nn/rnn.py", "ops/rnn_ops.py",
                   "ops/registry.py", "ops/math_ops.py", "ops/nn_ops.py",
                   "ops/tensor_ops.py", "ops/reduce_ops.py",
                   "ops/random_ops.py", "framework/program.py",
                   "framework/executor.py", "framework/backward.py",
                   "framework/scope.py", "layers/nn.py",
                   "static/__init__.py", "distributed/ps/host_paced.py",
                   "models/ctr.py", "models/static_encoder.py",
                   "ops/loss_ops.py", "ops/structured_ops.py",
                   "ops/index_ops.py", "ops/misc_ops.py",
                   "layers/sequence_lod.py", "layers/dynamic_rnn.py",
                   "layers/nn_extra.py", "layers/nn_veneer.py",
                   "framework_io.py", "fluid_compat.py", "dataset.py",
                   "models/book.py", "ops/control_flow_ops.py",
                   "ops/cuda/cond_graph.py", "ops/linalg_ops.py",
                   "ops/fused_ops.py", "layers/control_flow.py",
                   "ops/image_ops.py", "ops/detection_ops.py",
                   "ops/proposal_ops.py", "ops/ctr_ops.py",
                   "ops/quant_ops.py", "layers/detection.py",
                   "framework/ir.py", "slim/__init__.py",
                   "slim/quantization.py", "ops/cuda/nms.py",
                   "models/detection.py", "amp/static_amp.py",
                   "compiler.py", "distributed/__init__.py",
                   "distributed/env.py", "distributed/parallel.py",
                   "distributed/fleet/__init__.py",
                   "distributed/fleet/fleet_base.py",
                   "distributed/fleet/pipeline.py",
                   "distributed/fleet/distributed_strategy.py",
                   "distributed/fleet/role_maker.py",
                   "distributed/fleet/metrics.py",
                   "distributed/fleet/utils/__init__.py"):
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
    from paddle_tpu_torch import nn as tnn
    for make in (tnn.Transformer, lambda: tnn.LSTM(4, 8),
                 lambda: tnn.MultiHeadAttention(8, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


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
    "serving_host_blocks", "serving_demote_idle_ms", "serving_paged",
    # the compile tracker and the device-cost observatory (the peaks'
    # help names the port's nominals, not the reference's TPU/A100 ones)
    "warn_recompiles", "serving_devprof", "serving_devprof_sample",
    # the concurrency sanitizer
    "sanitize_locks")


def test_flags_keep_jax_names_and_defaults():
    ported = tflags.list_flags()
    jax_flags = jflags.list_flags()
    assert len(ported) == 65
    assert ported["sanitize_locks"]["default"] is False
    for name in ("devprof_peak_flops", "devprof_peak_hbm_gbps"):
        assert ported[name]["default"] == jax_flags[name]["default"] == 0.0
        assert "H100" in ported[name]["help"]
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


# ------------------------------------------------- public signatures (C1)
_P = inspect.Parameter
_VAR = (_P.VAR_POSITIONAL, _P.VAR_KEYWORD)


def _unwrapped(fn):
    """The function behind a reference wrapper that hides it (the
    generation entries' ``@no_grad()`` takes ``*a, **kw``): found in the
    wrapper's closure by name; None when the reference's own signature
    is only ``*a, **kw`` (its activation layers)."""
    params = list(inspect.signature(fn).parameters.values())
    if [p.kind for p in params if p.name != "self"] != list(_VAR):
        return fn
    for cell in getattr(fn, "__closure__", None) or ():
        inner = cell.cell_contents
        if callable(inner) and getattr(inner, "__name__", None) == \
                getattr(fn, "__name__", None) and inner is not fn:
            return _unwrapped(inner)
    return None


def _same_default(ported, ref) -> bool:
    if ported is ref:
        return True
    if isinstance(ported, torch.dtype):
        return str(ported).replace("torch.", "") == np.dtype(ref).name
    try:
        same = ported == ref
    except Exception:
        return False
    return same is True or (isinstance(same, (bool, np.bool_)) and bool(same))


def _drift(ported, ref):
    """How ``ported``'s parameters differ from ``ref``'s: the reference's
    names, kinds and defaults, in order, then only keyword-only (or
    ``**kw``) port-only parameters."""
    ref = _unwrapped(ref)
    if ref is None:
        return []
    tp = list(inspect.signature(ported).parameters.values())
    jp = list(inspect.signature(ref).parameters.values())
    out = []
    for i, j in enumerate(jp):
        if i >= len(tp):
            out.append(f"missing {j.name}")
            continue
        t = tp[i]
        if (t.name, t.kind) != (j.name, j.kind):
            out.append(f"#{i}: {t.name}/{t.kind} vs {j.name}/{j.kind}")
            break
        if not _same_default(t.default, j.default):
            out.append(f"{j.name} default {t.default!r} vs {j.default!r}")
    out += [f"port-only {t.name} is not keyword-only"
            for t in tp[len(jp):] if t.kind not in (_P.KEYWORD_ONLY,
                                                    _P.VAR_KEYWORD)]
    return out


def _shared_names():
    """(qualified name, port callable, reference callable) for every
    public function, class constructor and public method the port's
    modules share by name with the counterpart module of the JAX
    package."""
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        tmod = importlib.import_module(info.name)
        jname = "paddle_tpu" + info.name[len("paddle_tpu_torch"):]
        try:
            jmod = importlib.import_module(jname)
        except ImportError:
            continue
        for name in sorted(vars(tmod)):
            t = getattr(tmod, name)
            if name.startswith("_") or not hasattr(jmod, name) or \
                    getattr(t, "__module__", None) != tmod.__name__:
                continue
            j = getattr(jmod, name)
            qual = f"{info.name}.{name}"
            if inspect.isclass(t) and inspect.isclass(j):
                if "__init__" in vars(t) and "__init__" in vars(j):
                    yield qual, t.__init__, j.__init__
                for m, tv in vars(t).items():
                    jv = vars(j).get(m)
                    if not m.startswith("_") and inspect.isfunction(tv) \
                            and inspect.isfunction(jv):
                        yield f"{qual}.{m}", tv, jv
            elif inspect.isfunction(t) and callable(j):
                yield qual, t, j


def test_shared_public_names_keep_the_reference_signatures():
    """Every public name the two packages share takes the reference's
    parameters, in its order, with its defaults; port-only parameters
    (``device``, ``generator``, ``std``, ``attn_impl``, ``pin_memory``,
    ...) are keyword-only after them, so no positional call binds to
    another parameter in one package than in the other."""
    checked, bad = set(), {}
    for qual, t, j in _shared_names():
        checked.add(qual)
        drift = _drift(t, j)
        if drift:
            bad[qual] = drift
    assert not bad, bad
    assert len(checked) > 800
    # the fluid-era surface is among them
    assert {f"paddle_tpu_torch.{q}" for q in (
        "framework_io.save_inference_model",
        "framework_io.load_inference_model", "framework_io.save",
        "fluid_compat.DataFeeder.feed", "fluid_compat.batch",
        "fluid_compat.CUDAPlace", "dataset.InMemoryDataset",
        "layers.sequence_lod.dynamic_lstm",
        "layers.sequence_lod.sequence_conv",
        "layers.dynamic_rnn.DynamicRNN.memory",
        "layers.nn_extra.exponential_decay", "layers.nn_extra.warpctc",
        "layers.nn_veneer.slice")} <= checked
    # and the control-flow builders and the dense veneers
    assert {f"paddle_tpu_torch.layers.{q}" for q in (
        "control_flow.cond", "control_flow.while_loop",
        "control_flow.While", "control_flow.case",
        "control_flow.switch_case", "control_flow.less_than",
        "nn_veneer.py_func", "nn_veneer.group_norm",
        "nn_veneer.autoincreased_step_counter", "nn_veneer.smooth_l1",
        "nn_extra.masked_select")} <= checked
    # and the image, detection and quantization surface
    assert {f"paddle_tpu_torch.{q}" for q in (
        "layers.detection.multiclass_nms", "layers.detection.yolo_box",
        "layers.detection.roi_align", "layers.detection.anchor_generator",
        "layers.nn_extra.image_resize", "layers.nn_extra.grid_sampler",
        "layers.nn_extra.nce", "layers.nn_extra.spectral_norm",
        "layers.nn_extra.sampling_id", "layers.nn_veneer.conv3d_transpose",
        "layers.nn_veneer.deformable_conv", "layers.nn_veneer.random_crop",
        "layers.nn_veneer.psroi_pool", "framework.ir.IrGraph.find_chains",
        "framework.ir.PassManager", "framework.ir.apply_pass",
        "slim.quantization.quant_aware", "slim.quantization.convert",
        "slim.quantization.PostTrainingQuantization.collect")} <= checked
    # and the static rewrites, the fleet at one rank and the compiler
    assert {f"paddle_tpu_torch.{q}" for q in (
        "amp.static_amp.rewrite_program", "amp.static_amp.decorate",
        "amp.lists.AutoMixedPrecisionLists",
        "optimizer.RecomputeOptimizer.backward",
        "optimizer.PipelineOptimizer.runner",
        "optimizer.ExponentialMovingAverage",
        "optimizer.ExponentialMovingAverage.update",
        "optimizer.ModelAverage", "optimizer.LookaheadOptimizer.minimize",
        "distributed.parallel.init_parallel_env",
        "distributed.env.build_mesh",
        "distributed.fleet.fleet_base.Fleet.init",
        "distributed.fleet.fleet_base.Fleet.distributed_optimizer",
        "distributed.fleet.pipeline.split_pipeline_program",
        "distributed.fleet.pipeline.PipelineRunner",
        "distributed.fleet.pipeline.PipelineRunner.run",
        "distributed.fleet.metrics.auc",
        "distributed.fleet.utils.recompute",
        "compiler.CompiledProgram.with_data_parallel",
        "compiler.BuildStrategy")} <= checked


def test_port_tools_keep_the_reference_tools_signatures():
    """The soak and the serving lint are the port's copies of
    ``tools/soak.py`` and ``tools/lint_serving.py`` (not modules of the
    JAX package, so the walk above cannot pair them): every public
    function they share takes the reference's parameters."""
    from paddle_tpu_torch.tools import lint_serving, soak
    from tools import lint_serving as jlint_serving
    from tools import soak as jsoak
    checked = 0
    for tmod, jmod in ((soak, jsoak), (lint_serving, jlint_serving)):
        for name in sorted(vars(jmod)):
            j = getattr(jmod, name)
            if not inspect.isfunction(j) or \
                    getattr(j, "__module__", None) != jmod.__name__:
                continue
            assert hasattr(tmod, name), (tmod.__name__, name)
            assert not _drift(getattr(tmod, name), j), name
            checked += 1
    assert checked == 6


_ENGINE_KW = dict(max_slots=2, max_len=16, buckets=[8], device="cpu")


#: reference parameters the port takes but cannot honour yet, each with
#: the ROADMAP.md item it waits for: a call that sets one raises
#: NotImplementedError naming that item
WAITING = {
    "mesh (ServingEngine)": (
        "A5", lambda m: ServingEngine(m, mesh=object(), **_ENGINE_KW)),
    "mesh (decode_step_paged)": (
        "A5", lambda m: tgen.decode_step_paged(m, mesh=object())),
    "mesh (decode_megastep_paged)": (
        "A5", lambda m: tgen.decode_megastep_paged(m, 2, mesh=object())),
    "mesh (verify_step_paged)": (
        "A5", lambda m: tgen.verify_step_paged(m, 2, mesh=object())),
    "Linear weight_attr": (
        "A7", lambda m: TL.Linear(4, 4, weight_attr="w", device="cpu",
                                  generator=torch.Generator())),
    "BatchNorm2D bias_attr": (
        "A7", lambda m: TL.BatchNorm2D(4, bias_attr=False, device="cpu")),
    "framework_io.save (dygraph Tensors)": (
        "A7.5", lambda m: tio.save({"w": np.zeros(2)}, "unused")),
    "framework_io.load": ("A7.5", lambda m: tio.load("unused")),
    "InMemoryDataset": ("A7.4", lambda m: tdataset.InMemoryDataset(2)),
    "QueueDataset": ("A7.4", lambda m: tdataset.QueueDataset(
        slot_names=["a"])),
    "BlockKVCache dtype": (
        "ROADMAP C", lambda m: tkv.BlockKVCache(
            1, 1, 4, 2, 8, block_size=4, dtype=torch.bfloat16)),
}


@pytest.mark.parametrize("what", sorted(WAITING))
def test_waiting_parameters_raise_naming_their_item(what):
    item, call = WAITING[what]
    with pytest.raises(NotImplementedError, match=item):
        call(GPTForCausalLM(TINY, device="cpu"))


def test_set_lr_with_a_scope_writes_the_program_lr_like_the_reference():
    """``set_lr(value, scope=)`` (a waiting case before the static plane
    came) writes the Program's learning-rate variable into the scope as
    ``paddle_tpu/optimizer.py:237-243`` does, and the next step uses it;
    before ``minimize`` made that variable it touches no scope, in both
    packages. An eager optimizer's own rate follows as well."""
    import paddle_tpu.layers as JL
    import paddle_tpu.optimizer as JO
    from paddle_tpu.framework import Executor as JExecutor
    from paddle_tpu.framework import Program as JProgram
    from paddle_tpu.framework import Scope as JScope
    from paddle_tpu.framework import program_guard as jguard
    from paddle_tpu.framework import unique_name as jun
    from paddle_tpu_torch import layers as TLy
    from paddle_tpu_torch.framework import (Executor, Program, Scope,
                                            program_guard, unique_name)
    from paddle_tpu_torch.models.convert import scope_from_numpy

    def build(P, L, un, guard, O):
        main, startup = P(), P()
        main.random_seed = startup.random_seed = 9
        with guard(main, startup), un.guard():
            x = L.data("x", [3])
            loss = L.reduce_mean(L.square(L.fc(x, 2)))
            opt = O.SGD(learning_rate=0.1)
            opt.set_lr(0.3, scope=object())        # no lr var yet: no-op
            opt.minimize(loss)
        return main, startup, loss, opt

    saved = tflags.get_flags(["check_program"])
    tflags.set_flags({"check_program": False})
    try:
        jm, js, jl, jopt = build(JProgram, JL, jun, jguard, JO)
        tm, _, tl, t_opt = build(Program, TLy, unique_name, program_guard,
                                 topt)
        jscope, jexe = JScope(), JExecutor()
        jexe.run(js, scope=jscope)
        tscope = scope_from_numpy({n: jscope.get_numpy(n)
                                   for n in jscope.var_names()}, "cpu")
        texe = Executor("cpu")
        x = np.random.RandomState(4).randn(4, 3).astype(np.float32)
        for lr in (None, 0.5, 0.0):
            if lr is not None:
                jopt.set_lr(lr, scope=jscope)
                t_opt.set_lr(lr, scope=tscope)
            (a,) = jexe.run(jm, feed={"x": x}, fetch_list=[jl.name],
                            scope=jscope)
            (b,) = texe.run(tm, feed={"x": x}, fetch_list=[tl.name],
                            scope=tscope)
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
        for n in jscope.var_names():
            np.testing.assert_allclose(tscope.get_numpy(n),
                                       jscope.get_numpy(n), rtol=1e-5,
                                       atol=1e-6)
        assert float(tscope.get_numpy(t_opt.get_lr_var().name)[0]) == 0.0
    finally:
        tflags.set_flags(saved)
    eager = topt.SGD(learning_rate=0.1, parameters=[
        ("w", torch.nn.Parameter(torch.ones(2)))])
    eager.set_lr(0.25, scope=Scope())
    assert eager.get_lr() == 0.25


# ------------------------------------- the loss and dropout (C1 parity)
def _j(a):
    return JTensor(jnp.asarray(a))


def test_cross_entropy_positional_probe_equals_the_reference():
    """``cross_entropy(x, y, False)``: the third positional argument is
    ``soft_label`` in both packages (the port used to bind it to
    ``ignore_index`` and drop label 0): 1.593791 in both."""
    x = np.random.RandomState(0).randn(4, 5).astype(np.float32)
    y = np.array([0, 1, 0, 3], np.int64)
    j = float(JF.cross_entropy(_j(x), _j(y), False).numpy())
    t = float(TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(y),
                               False))
    assert round(j, 6) == round(t, 6) == 1.593791


@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("axis", [-1, 1, 0])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_cross_entropy_soft_label_and_axis_match_the_reference(
        soft, axis, reduction):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 5, 3).astype(np.float32)
    n = x.shape[axis]
    if soft:
        lbl = rng.rand(*x.shape).astype(np.float32)
        lbl /= lbl.sum(axis=axis, keepdims=True)
    else:
        shape = list(x.shape)
        shape[axis] = 1
        lbl = rng.randint(0, n, size=shape).astype(np.int64)
        lbl.flat[1] = -100                # one ignored label
    j = JF.cross_entropy(_j(x), _j(lbl), soft_label=soft,
                         reduction=reduction, axis=axis).numpy()
    t = TF.cross_entropy(torch.from_numpy(x), torch.from_numpy(lbl),
                         soft_label=soft, reduction=reduction, axis=axis)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-6)
    layer = TL.CrossEntropyLoss(soft, -100, reduction, axis)
    np.testing.assert_allclose(
        layer(torch.from_numpy(x), torch.from_numpy(lbl)).numpy(),
        np.asarray(j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["upscale_in_train", "downscale_in_infer"])
def test_dropout_mode_matches_the_reference(mode):
    """Outside training both packages return the same values (``x`` or
    ``x * (1 - p)``); in training each keeps a subset of ``x`` scaled by
    ``1 / (1 - p)`` (upscale) or unscaled (downscale), from its own
    random bits."""
    p = 0.25
    x = np.random.RandomState(5).randn(64, 32).astype(np.float32) + 3.0
    j = np.asarray(JF.dropout(_j(x), p, training=False, mode=mode).numpy())
    t = TF.dropout(torch.from_numpy(x), p, training=False, mode=mode)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-7)
    layer = TL.Dropout(p, mode=mode).eval()
    np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(), j,
                               rtol=1e-7)
    scale = 1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0
    jt = np.asarray(JF.dropout(_j(x), p, training=True, mode=mode).numpy())
    tt = TF.dropout(torch.from_numpy(x), p, training=True, mode=mode).numpy()
    for out in (jt, tt):
        kept = out != 0
        assert 0.6 < kept.mean() < 0.9
        np.testing.assert_allclose(out[kept], (x * scale)[kept], rtol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        TF.dropout(torch.from_numpy(x), p, mode="bogus")
