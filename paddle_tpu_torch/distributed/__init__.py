"""Distributed plane of the port: the one-rank environment (:mod:`.env`,
:mod:`.parallel`), the fleet's strategy chain, pipeline runner and
metrics (:mod:`.fleet`) and the parameter-server tier (:mod:`.ps`: the
host tables, the host-paced loop, the runtime of the in-graph lookup,
the RPC wire and its servers). Meshes over several cards, the
collectives, ZeRO, the ring route and spawn wait for ROADMAP A5."""

from . import env
from . import fleet
from .parallel import ParallelEnv, get_rank, get_world_size, init_parallel_env
