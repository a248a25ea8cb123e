"""CompiledProgram — the ParallelExecutor front door; the counterpart of
``paddle_tpu/compiler.py`` at one rank.

Analog of python/paddle/fluid/compiler.py:87 (CompiledProgram
.with_data_parallel). The reference runs the Program's step under
``jax.shard_map`` over the device mesh (``_ParallelRunner``,
``compiler.py:107``): feeds shard on the batch axis, parameters
replicate, the fleet's ``c_allreduce_sum`` ops reduce over the data axis.
The port runs one rank: ``Executor.run`` opens a CompiledProgram through
its ``_compile_for_executor`` door, which applies the BuildStrategy's IR
passes once (the port's :class:`~paddle_tpu_torch.framework.ir.
PassManager`) and runs the program through the executor's own path (on
the card its CUDA graphs). Fetches keep the reference's ParallelExecutor
form: each per-device result stacked on a leading axis, then the first
two axes merged (a scalar comes back as ``[1]``). A mesh of more than
one rank raises NotImplementedError naming ROADMAP A5.

BuildStrategy/ExecutionStrategy knobs are accepted for API parity; the
ones with an IR pass map through, the scheduling knobs are no-ops.
"""

from __future__ import annotations

from typing import Optional

from .framework.program import Program


class BuildStrategy:
    """API-parity knob struct (details/build_strategy.h)."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = 0
        self.memory_optimize = None
        self.enable_inplace = None
        self.fuse_all_reduce_ops = True
        self.fuse_broadcast_ops = True
        self.fuse_elewise_add_act_ops = False  # ir pass when True
        self.fuse_bn_act_ops = False           # ir pass when True
        self.num_trainers = 1
        self.trainer_id = 0
        self.sync_batch_norm = False

    def _ir_passes(self):
        """Pass names this strategy turns on (build_strategy.cc
        AppendPass analog); applied by CompiledProgram."""
        names = []
        if self.fuse_elewise_add_act_ops:
            names.append("fuse_elewise_add_act_pass")
        if self.fuse_bn_act_ops:
            names.append("fuse_bn_act_pass")
        return names


class ExecutionStrategy:
    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = True


class CompiledProgram:
    def __init__(self, program: Program, build_strategy: Optional[BuildStrategy] = None):
        self._program = program
        self._build_strategy = build_strategy or BuildStrategy()
        self._passes_applied = False
        self._exec_strategy = ExecutionStrategy()
        self._data_parallel = False
        self._loss_name = None
        self._share_vars_from = None
        self._mesh = None
        self._data_axis = "dp"

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy: Optional[ExecutionStrategy] = None,
                           share_vars_from=None, places=None):
        """Analog of compiler.py:160. The mesh is found (or made) at the
        first run."""
        self._data_parallel = True
        self._loss_name = loss_name
        if build_strategy is not None:
            self._build_strategy = build_strategy
        if exec_strategy is not None:
            self._exec_strategy = exec_strategy
        self._share_vars_from = share_vars_from
        return self

    # executor protocol ----------------------------------------------------
    def _compile_for_executor(self, executor):
        names = self._build_strategy._ir_passes()
        if names and not self._passes_applied:
            from .framework.ir import PassManager
            self._program = PassManager(names).apply(self._program)
            self._passes_applied = True
        return _ParallelRunner(self, executor)


class _ParallelRunner:
    """Runs a CompiledProgram (the ParallelExecutor analog) at one rank
    through the executor's path."""

    def __init__(self, compiled: CompiledProgram, executor):
        self.c = compiled
        self.executor = executor

    def _mesh(self):
        if self.c._mesh is not None:
            return self.c._mesh
        from .distributed import env as dist_env
        mesh = dist_env.current_mesh()
        if mesh is None:
            from .distributed.env import build_mesh
            mesh = build_mesh((self.c._data_axis,),
                              devices=[self.executor.device])
            dist_env.set_mesh(mesh)
            dist_env.register_ring(0, self.c._data_axis)
        self.c._mesh = mesh
        return mesh

    def run(self, feed=None, fetch_list=None, scope=None, return_numpy=True):
        mesh = self._mesh()
        ndev = int(mesh.shape.get(self.c._data_axis, 1)) \
            if self.c._data_axis in mesh.axis_names else int(mesh.size)
        if ndev != 1:
            raise NotImplementedError(
                f"CompiledProgram over {ndev} ranks (the SPMD runner) "
                "waits for ROADMAP A5")
        outs = self.executor._run(self.c._program, feed, fetch_list,
                                  scope, return_numpy)
        # ParallelExecutor fetch semantics: per-device results stacked on
        # a leading axis, then the first two axes merged
        out = []
        for f in outs:
            f = f[None]
            if f.ndim >= 2:
                f = f.reshape((-1,) + tuple(f.shape[2:]))
            out.append(f)
        return out
