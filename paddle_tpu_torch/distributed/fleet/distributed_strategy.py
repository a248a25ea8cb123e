"""DistributedStrategy — the fleet config tree; the port's copy of
``paddle_tpu/distributed/fleet/distributed_strategy.py``, whole.

Analog of python/paddle/distributed/fleet/base/distributed_strategy.py
backed by framework/distributed_strategy.proto:94-130. Same field surface
(amp, recompute, dgc, gradient_merge, lamb, lars, localsgd, pipeline,
a_sync, hierarchical_allreduce, fuse_all_reduce...) plus the post-reference
fields the north star needs: sharding (ZeRO stages), tensor/sequence
parallel. Serialized as a dict (the proto's JSON form).
"""

from __future__ import annotations

import copy
import json


_DEFAULTS = {
    # collective
    "amp": False,
    "amp_configs": {"init_loss_scaling": 32768.0, "use_dynamic_loss_scaling":
                    True, "custom_white_list": [], "custom_black_list": [],
                    "use_pure_bf16": False},
    "recompute": False,
    "recompute_configs": {"checkpoints": []},
    "gradient_merge": False,
    "gradient_merge_configs": {"k_steps": 1, "avg": True},
    "lamb": False,
    "lamb_configs": {"lamb_weight_decay": 0.01, "exclude_from_weight_decay": []},
    "lars": False,
    "lars_configs": {"lars_coeff": 0.001, "lars_weight_decay": 0.0005},
    "localsgd": False,
    "localsgd_configs": {"k_steps": 1},
    "dgc": False,
    "dgc_configs": {"rampup_begin_step": 0, "rampup_step": 1,
                    "sparsity": [0.999]},
    "pipeline": False,
    "pipeline_configs": {"micro_batch": 1, "accumulate_steps": 1},
    "a_sync": False,
    "a_sync_configs": {"k_steps": -1, "max_merge_var_num": 20,
                       "send_queue_size": 20, "independent_recv_thread":
                       False, "min_send_grad_num_before_recv": 20,
                       "thread_pool_size": 1, "send_wait_times": 1,
                       "runtime_split_send_recv": False, "launch_barrier":
                       True, "heter_worker_device_guard": "cpu"},
    "hierarchical_allreduce": False,
    "hierarchical_allreduce_inter_nranks": 1,
    "nccl_comm_num": 1,
    "sync_nccl_allreduce": True,
    "fuse_all_reduce_ops": True,
    "fuse_grad_size_in_MB": 32,
    "fuse_grad_size_in_TFLOPS": 50.0,
    "cudnn_exhaustive_search": False,
    "conv_workspace_size_limit": 512,
    "cudnn_batchnorm_spatial_persistent": False,
    "sync_batch_norm": False,
    "elastic": False,
    "auto": False,
    # beyond the reference (north-star capabilities)
    "sharding": False,
    "sharding_configs": {"stage": 2, "sharding_degree": 1},
    "tensor_parallel": False,
    "tensor_parallel_configs": {"tensor_parallel_degree": 1},
    "sequence_parallel": False,
    "sequence_parallel_configs": {"degree": 1, "ring_attention": True},
}


class DistributedStrategy:
    def __init__(self):
        self._d = copy.deepcopy(_DEFAULTS)

    def __getattr__(self, name):
        d = object.__getattribute__(self, "_d")
        if name in d:
            return d[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        if name == "_d":
            object.__setattr__(self, name, value)
            return
        if name not in self._d:
            raise AttributeError(f"unknown strategy field {name!r}")
        if name.endswith("_configs"):
            merged = dict(self._d[name])
            merged.update(value)
            self._d[name] = merged
        else:
            self._d[name] = value

    def to_dict(self):
        return copy.deepcopy(self._d)

    def save_to_prototxt(self, path):
        with open(path, "w") as f:
            json.dump(self._d, f, indent=2)

    def load_from_prototxt(self, path):
        with open(path) as f:
            self._d.update(json.load(f))

    def __repr__(self):
        on = [k for k, v in self._d.items()
              if isinstance(v, bool) and v]
        return f"DistributedStrategy(enabled={on})"
