"""Fleet — the distributed training facade (the counterpart of
``paddle_tpu/distributed/fleet``) at one rank: the strategy chain
(``fleet_base``), the pipeline runner (``pipeline``), the strategy and
role maker, ``metrics``, the PS lifecycle and ``utils`` (the filesystem
shell, the KV HTTP server). ``fleet.utils.recompute`` waits for ROADMAP
A7.5b (it runs on the dygraph tape) and ``elastic`` for A8 (it drives the
checkpoint plane and spawns processes)."""

from . import metrics
from .distributed_strategy import DistributedStrategy
from .fleet_base import Fleet, fleet
from .role_maker import PaddleCloudRoleMaker, Role, UserDefinedRoleMaker

# module-level passthroughs so `from paddle_tpu_torch.distributed import
# fleet; fleet.init(...)` works like the reference
init = fleet.init
is_first_worker = fleet.is_first_worker
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_worker = fleet.is_worker
is_server = fleet.is_server
worker_endpoints = fleet.worker_endpoints
server_endpoints = fleet.server_endpoints
barrier_worker = fleet.barrier_worker
init_worker = fleet.init_worker
init_server = fleet.init_server
run_server = fleet.run_server
stop_worker = fleet.stop_worker
distributed_optimizer = fleet.distributed_optimizer
distributed_model = fleet.distributed_model
save_persistables = fleet.save_persistables
save_inference_model = fleet.save_inference_model


def __getattr__(name):
    # PEP 562: dynamic attrs resolving to live fleet state, so
    # ``fleet.main_program`` from the module behaves like the reference's
    # Fleet property
    if name == "main_program":
        return fleet.main_program
    if name == "util":
        from . import utils
        return utils
    if name == "elastic":
        raise NotImplementedError(
            "fleet.elastic (the elastic manager: incubate.checkpoint and "
            "spawned trainers) waits for ROADMAP A8")
    raise AttributeError(name)
