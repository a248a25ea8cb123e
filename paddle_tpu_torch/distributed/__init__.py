"""Distributed plane of the port: the one-rank environment (:mod:`.env`,
:mod:`.parallel`), the fleet's strategy chain, pipeline runner and
metrics (:mod:`.fleet`) and the parameter-server tier (:mod:`.ps`: the
host tables, the host-paced loop, the runtime of the in-graph lookup,
the RPC wire and its servers) and the eager collectives at one rank
(:mod:`.collective`). Meshes over several cards, the collectives across
them, ZeRO, the ring route and spawn wait for ROADMAP A5b."""

from . import collective, env
from .collective import (ReduceOp, all_gather, all_reduce, barrier,
                         broadcast, reduce, reduce_scatter, scatter, split)
from . import fleet
from .parallel import ParallelEnv, get_rank, get_world_size, init_parallel_env
