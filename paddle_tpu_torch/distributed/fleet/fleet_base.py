"""Fleet facade — the unified distributed-training front door; the
counterpart of ``paddle_tpu/distributed/fleet/fleet_base.py`` at one
rank.

Analog of python/paddle/distributed/fleet/base/fleet_base.py (Fleet:62,
init:124, distributed_optimizer:571, minimize:936) and the meta-optimizer
chain it compiles (strategy_compiler.py:41, meta_optimizer_factory.py:21).

Static collective flow: ``fleet.init(is_collective=True)`` sets up the
(one-device) mesh; ``fleet.distributed_optimizer(opt, strategy)`` wraps
the user optimizer; ``minimize(loss)`` applies the enabled
meta-optimizers in the reference's order — the LAMB/LARS swap, the AMP
rewrite, backward (with recompute segments), gradient-merge
accumulation, the optimizer apply, the pipeline split — then compiles
the program (``fleet.main_program`` is a
:class:`~paddle_tpu_torch.compiler.CompiledProgram`).

What exists only across ranks raises NotImplementedError naming ROADMAP
A5: the per-gradient ``c_allreduce_sum`` insertion with DGC
(:func:`_insert_grad_allreduce`), ZeRO stage 2
(:func:`_apply_sharding_stage2`), LocalSGD (:func:`_apply_localsgd`) and
the dygraph ``distributed_model``. At one rank the chain never calls
them, as the reference's does not. The PS lifecycle waits with the PS
runtime for A7.4.
"""

from __future__ import annotations

from typing import Optional

from ...framework import unique_name
from ...framework.program import Program, default_main_program
from .distributed_strategy import DistributedStrategy
from .role_maker import PaddleCloudRoleMaker

_A5 = ("runs across ranks and waits for ROADMAP A5 (the port runs one "
       "rank)")


class Fleet:
    def __init__(self):
        self._role_maker: Optional[PaddleCloudRoleMaker] = None
        self._strategy: Optional[DistributedStrategy] = None
        self._is_collective = True
        self._final_program = None
        self._origin_main_program = None

    # -- lifecycle ---------------------------------------------------------
    def init(self, role_maker=None, is_collective: bool = True,
             strategy: Optional[DistributedStrategy] = None):
        self._role_maker = role_maker or PaddleCloudRoleMaker(is_collective)
        self._is_collective = is_collective
        self._strategy = strategy or DistributedStrategy()
        from ..parallel import init_parallel_env
        if is_collective:
            init_parallel_env()
        return self

    def is_first_worker(self):
        return self._role_maker.is_first_worker()

    def worker_index(self):
        return self._role_maker.worker_index()

    def worker_num(self):
        return self._role_maker.worker_num()

    def is_worker(self):
        return self._role_maker.is_worker()

    def is_server(self):
        return self._role_maker.is_server()

    def worker_endpoints(self, to_string=False):
        eps = self._role_maker.get_trainer_endpoints()
        return ",".join(eps) if to_string else eps

    def server_endpoints(self, to_string=False):
        eps = self._role_maker.get_pserver_endpoints()
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        pass  # single-controller SPMD: nothing to rendezvous

    # -- PS lifecycle (the ps runtime: ROADMAP A7.4) ------------------------
    def init_worker(self):
        raise NotImplementedError(
            "fleet.init_worker: the PS runtime waits for ROADMAP A7.4")

    def init_server(self, *args, **kwargs):
        raise NotImplementedError(
            "fleet.init_server: the PS runtime waits for ROADMAP A7.4")

    def run_server(self):
        raise NotImplementedError(
            "fleet.run_server: the PS runtime waits for ROADMAP A7.4")

    def stop_worker(self):
        raise NotImplementedError(
            "fleet.stop_worker: the PS runtime waits for ROADMAP A7.4")

    # -- optimizer ---------------------------------------------------------
    def distributed_optimizer(self, optimizer,
                              strategy: Optional[DistributedStrategy] = None):
        if strategy is not None:
            self._strategy = strategy
        return _DistributedOptimizer(self, optimizer,
                                     self._strategy or DistributedStrategy())

    # -- dygraph -----------------------------------------------------------
    def distributed_model(self, model):
        raise NotImplementedError(f"fleet.distributed_model {_A5}")

    @property
    def main_program(self):
        return self._final_program or default_main_program()

    def pipeline_runner(self, devices=None, schedule=None):
        """Microbatch runner for a strategy.pipeline minimize().
        ``devices`` gives each stage an executor there; ``schedule``
        picks "gpipe" or "1f1b" (defaults to the strategy's
        pipeline_configs["schedule"] or gpipe)."""
        runner = getattr(self, "_pipeline_runner", None)
        if runner is None:
            raise ValueError("no pipeline program; set strategy.pipeline "
                             "and call minimize() first")
        new_devices = devices if devices is not None else runner.devices
        new_schedule = schedule or runner.schedule
        if (new_devices != runner.devices
                or new_schedule != runner.schedule):
            from .pipeline import PipelineRunner
            runner = PipelineRunner(
                runner.stages, runner.num_microbatches,
                devices=new_devices, schedule=new_schedule)
            self._pipeline_runner = runner
        return runner

    # -- checkpoint passthroughs ------------------------------------------
    def save_persistables(self, executor, dirname, main_program=None):
        from ...framework_io import save_persistables
        save_persistables(executor, dirname,
                          main_program or self._origin_main_program)

    def save_inference_model(self, executor, dirname, feeded_var_names,
                             target_vars, main_program=None):
        from ...framework_io import save_inference_model
        save_inference_model(dirname, feeded_var_names, target_vars,
                             executor, main_program or
                             self._origin_main_program)


class _DistributedOptimizer:
    """Meta-optimizer chain applier (strategy_compiler analog)."""

    def __init__(self, fleet: Fleet, optimizer, strategy: DistributedStrategy):
        self._fleet = fleet
        self._inner = optimizer
        self._strategy = strategy

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        self._fleet._origin_main_program = program
        opt = self._inner
        strategy = self._strategy

        # 1. LAMB/LARS meta-optimizers: swap the inner optimizer
        #    (meta_optimizers/lamb_optimizer.py / lars_optimizer.py)
        from ...optimizer import LambOptimizer, LarsMomentumOptimizer
        if strategy.lamb and not isinstance(opt, LambOptimizer):
            cfg = strategy.lamb_configs
            opt = LambOptimizer(
                learning_rate=opt._learning_rate,
                lamb_weight_decay=cfg["lamb_weight_decay"],
                grad_clip=opt._grad_clip)
        if strategy.lars and not isinstance(opt, LarsMomentumOptimizer):
            cfg = strategy.lars_configs
            opt = LarsMomentumOptimizer(
                learning_rate=opt._learning_rate,
                momentum=getattr(opt, "_momentum", 0.9),
                lars_coeff=cfg["lars_coeff"],
                lars_weight_decay=cfg["lars_weight_decay"],
                grad_clip=opt._grad_clip)

        # 2. AMP rewrite (meta_optimizers/amp_optimizer.py)
        if strategy.amp:
            from ...amp.static_amp import rewrite_program
            from ...amp.lists import AutoMixedPrecisionLists
            cfg = strategy.amp_configs
            rewrite_program(program, AutoMixedPrecisionLists(
                cfg.get("custom_white_list"), cfg.get("custom_black_list")))

        # 3. backward (with recompute segments when enabled) +
        #    (optionally compressed) grads + allreduce
        checkpoints = None
        if strategy.recompute:
            checkpoints = (strategy.recompute_configs or {}).get(
                "checkpoints")
            if not checkpoints:
                raise ValueError(
                    "strategy.recompute=True requires "
                    "recompute_configs={'checkpoints': [...]}")
        params_grads = opt.backward(loss, startup_program, parameter_list,
                                    no_grad_set, checkpoints=checkpoints)
        nranks = self._nranks()
        # localsgd trains locally between syncs — no per-grad allreduce;
        # sharding replaces it with reduce-scatter (step 4a)
        if nranks > 1 and not strategy.localsgd and not strategy.sharding:
            params_grads = _insert_grad_allreduce(
                program, params_grads, nranks,
                dgc=strategy.dgc, dgc_configs=strategy.dgc_configs)

        # 4. gradient merge (meta_optimizers/gradient_merge_optimizer.py)
        if strategy.gradient_merge:
            cfg = strategy.gradient_merge_configs
            params_grads = _apply_gradient_merge(
                program, params_grads, cfg["k_steps"], cfg["avg"])

        # 4a. ZeRO stage-2 sharding: reduce-scatter grads, per-shard
        # optimizer state/update, all-gather params (north-star axis;
        # absent from the reference's proto:94-130 — new capability)
        if strategy.sharding and nranks > 1:
            cfg = strategy.sharding_configs or {}
            stage = int(cfg.get("stage", 2))
            # the strategy default sharding_degree=1 means "auto":
            # shard over the whole data axis
            degree = int(cfg.get("sharding_degree", 0))
            degree = nranks if degree <= 1 else degree
            if stage != 2 or degree != nranks:
                raise NotImplementedError(
                    f"static sharding supports stage=2 over the full "
                    f"data axis (got stage={stage}, sharding_degree="
                    f"{degree} with nranks={nranks}); stage 3 lives on "
                    "the dygraph to_static(mesh=..., FULLY_SHARDED_"
                    "RULES) path")
            if getattr(opt, "_grad_clip", None) is not None:
                raise NotImplementedError(
                    "sharding + grad_clip: clip norms would need a "
                    "cross-shard reduction; unset grad_clip or use the "
                    "dygraph to_static(mesh=...) path")
            opt_ops = _apply_sharding_stage2(
                program, opt, params_grads, nranks, startup_program)
            from ...compiler import CompiledProgram
            self._fleet._final_program = CompiledProgram(
                program).with_data_parallel(loss_name=loss.name)
            return opt_ops, params_grads

        opt_ops = opt.apply_gradients(params_grads, startup_program)

        # 4b. localsgd periodic parameter averaging (after optimizer ops)
        if strategy.localsgd and nranks > 1:
            cfg = strategy.localsgd_configs or {}
            _apply_localsgd(program, [p for p, _ in params_grads], nranks,
                            int(cfg.get("k_steps", 1)))

        # 4c. pipeline: split into per-stage phase programs (GPipe);
        # the user drives them with fleet.pipeline_runner()
        if strategy.pipeline:
            from .pipeline import PipelineRunner, split_pipeline_program
            cfg = strategy.pipeline_configs or {}
            n_mb = int(cfg.get("accumulate_steps", 1)) or 1
            stages = split_pipeline_program(program, n_mb)
            program._pipeline_stages = stages
            program._pipeline_num_microbatches = n_mb
            self._fleet._pipeline_runner = PipelineRunner(
                stages, n_mb, schedule=cfg.get("schedule", "gpipe"))
            self._fleet._final_program = program
            return opt_ops, params_grads

        # 5. compile for SPMD execution (graph_execution meta-optimizer)
        from ...compiler import CompiledProgram
        self._fleet._final_program = CompiledProgram(
            program).with_data_parallel(loss_name=loss.name)
        return opt_ops, params_grads

    def _nranks(self) -> int:
        from .. import env as dist_env
        mesh = dist_env.current_mesh()
        ax = dist_env.current_data_axis()
        if mesh is not None and ax in (mesh.axis_names or ()):
            return int(mesh.shape[ax])
        return 1


def _insert_grad_allreduce(program: Program, params_grads, nranks: int,
                           dgc=False, dgc_configs=None):
    """The GradAllReduce transpiler (transpiler/collective.py:36,178),
    with DGC's top-k and error feedback before each allreduce: the
    reference's ``fleet_base.py:279``."""
    raise NotImplementedError(
        f"the per-gradient c_allreduce_sum insertion (and DGC) {_A5}")


def _apply_sharding_stage2(program: Program, opt, params_grads,
                           nranks: int, startup_program=None):
    """ZeRO stage 2 over the data axis: the reference's
    ``fleet_base.py:384``."""
    raise NotImplementedError(f"static sharding stage 2 {_A5}")


def _persistable_zeros(program: Program, name: str, shape, dtype):
    """Declare a zero-initialized persistable var in main + startup."""
    from ...framework.program import default_startup_program
    block = program.global_block()
    block.create_var(name, shape=shape, dtype=dtype, persistable=True,
                     stop_gradient=True)
    startup = getattr(program, "_startup_ref", None) or \
        default_startup_program()
    sb = startup.global_block()
    sv = sb.create_var(name, shape=shape, dtype=dtype, persistable=True,
                       stop_gradient=True)
    sb.append_op("fill_constant", {}, {"Out": sv.name},
                 {"shape": list(shape), "dtype": dtype, "value": 0.0})


def _apply_localsgd(program: Program, params, nranks: int, k_steps: int):
    """LocalSGD's periodic parameter averaging across the data axis: the
    reference's ``fleet_base.py:514``."""
    raise NotImplementedError(f"LocalSGD {_A5}")


def _emit_every_k_gate(block, step_name: str, k_steps: int,
                       op_role: str):
    """Counter += 1; gate_b = (counter %% k == 0). Shared by
    gradient-merge and LocalSGD so the two stay in lockstep."""
    def ap(type_, ins, outs, attrs=None):
        block.append_op(type_, ins, outs,
                        dict(attrs or {}, op_role=op_role))

    one = unique_name.generate("gate_one")
    block.create_var(one, stop_gradient=True)
    ap("fill_constant_like", {"X": step_name}, {"Out": one},
       {"value": 1.0})
    ap("sum", {"X": [step_name, one]}, {"Out": step_name}, {})
    kc = unique_name.generate("gate_k")
    block.create_var(kc, stop_gradient=True)
    ap("fill_constant_like", {"X": step_name}, {"Out": kc},
       {"value": float(k_steps)})
    modv = unique_name.generate("gate_mod")
    block.create_var(modv, stop_gradient=True)
    ap("elementwise_mod", {"X": step_name, "Y": kc}, {"Out": modv}, {})
    zero = unique_name.generate("gate_zero")
    block.create_var(zero, stop_gradient=True)
    ap("fill_constant_like", {"X": step_name}, {"Out": zero},
       {"value": 0.0})
    gate_b = unique_name.generate("gate_b")
    block.create_var(gate_b, stop_gradient=True)
    ap("equal", {"X": modv, "Y": zero}, {"Out": gate_b}, {})
    return gate_b


def _apply_gradient_merge(program: Program, params_grads, k_steps: int,
                          avg: bool = True):
    """Gradient-merge rewrite (fluid/optimizer.py GradientMergeOptimizer:
    4994): accumulate grads into persistable buffers; apply every k steps.
    The step counter and the conditional apply are real ops; the optimizer
    consumes gated gradients (zero on non-apply steps keeps params frozen
    between merges when combined with the gate-scaled learning rate var)."""
    if k_steps <= 1:
        return params_grads
    from ...layers.tensor import create_global_var
    block = program.global_block()
    step = create_global_var([1], 0, "int64", persistable=True,
                             name=unique_name.generate("gm_step"))
    gate_b = _emit_every_k_gate(block, step.name, k_steps, "backward")
    gate = block.create_var(unique_name.generate("gm_gate"),
                            stop_gradient=True)
    block.append_op("cast", {"X": gate_b}, {"Out": gate},
                    {"in_dtype": "bool", "out_dtype": "float32",
                     "op_role": "backward"})
    out_pg = []
    for p, g in params_grads:
        acc = create_global_var(list(p.shape), 0.0, p.dtype, persistable=True,
                                name=unique_name.generate(f"{p.name}@GMERGE"))
        # acc += g
        block.append_op("sum", {"X": [acc.name, g.name]}, {"Out": acc},
                        {"op_role": "backward"})
        # gated grad = gate * acc / (k if avg)
        gated = block.create_var(unique_name.generate(g.name + "@GMG"),
                                 stop_gradient=True)
        block.append_op("elementwise_mul", {"X": acc, "Y": gate},
                        {"Out": gated}, {"axis": -1, "op_role": "backward"})
        if avg:
            avgd = block.create_var(unique_name.generate(g.name + "@GMA"),
                                    stop_gradient=True)
            block.append_op("scale", {"X": gated}, {"Out": avgd},
                            {"scale": 1.0 / k_steps, "op_role": "backward"})
            gated = avgd
        # reset acc on apply steps: acc = acc * (1 - gate)
        inv = block.create_var(unique_name.generate("gm_inv"),
                               stop_gradient=True)
        block.append_op("scale", {"X": gate}, {"Out": inv},
                        {"scale": -1.0, "bias": 1.0, "op_role": "backward"})
        block.append_op("elementwise_mul", {"X": acc, "Y": inv},
                        {"Out": acc}, {"axis": -1, "op_role": "backward"})
        out_pg.append((p, block.var(gated.name)))
    program.bump_version()
    return out_pg


fleet = Fleet()
