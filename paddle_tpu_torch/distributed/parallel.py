"""Process and mesh initialization — the counterpart of
``paddle_tpu/distributed/parallel.py`` at one rank.

``ParallelEnv`` reads the launcher's environment variables as the
reference does; :func:`init_parallel_env` builds the one-device mesh
(:func:`~.env.build_mesh`) that the fleet reads for its rank count,
registers ring 0 to the data axis and returns the ``ParallelEnv``. A
launcher environment naming more than one trainer (``PADDLE_TRAINERS_NUM``
above 1, or ``PADDLE_COORDINATOR``) raises NotImplementedError naming
ROADMAP A5, which brings the processes, the mesh over cards and their
collectives.
"""

from __future__ import annotations

import os
from typing import Optional


class ParallelEnv:
    """Analog of fluid/dygraph/parallel.py ParallelEnv:62 — env-derived
    topology (PADDLE_TRAINER_ID etc. honored for launcher parity)."""

    def __init__(self):
        self._rank = int(os.getenv("PADDLE_TRAINER_ID", "0"))
        self._world_size = int(os.getenv("PADDLE_TRAINERS_NUM", "1"))
        self._endpoints = os.getenv("PADDLE_TRAINER_ENDPOINTS", "").split(",")
        self._current_endpoint = os.getenv("PADDLE_CURRENT_ENDPOINT", "")

    @property
    def rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world_size

    @property
    def trainer_endpoints(self):
        return self._endpoints

    @property
    def current_endpoint(self):
        return self._current_endpoint

    # legacy names
    local_rank = rank
    nranks = world_size


def _one_rank():
    env = ParallelEnv()
    if env.world_size > 1 or os.getenv("PADDLE_COORDINATOR"):
        raise NotImplementedError(
            f"a launcher environment of {env.world_size} trainers: the "
            "port runs one rank; multi-process training waits for "
            "ROADMAP A5")
    return env


def init_parallel_env(data_axis: str = "dp",
                      mesh_shape: Optional[dict] = None):
    """Create the one-device mesh (over the card) and register ring 0 ->
    data axis. ``mesh_shape`` (axis name -> size) must give every axis
    size 1. Returns the ParallelEnv."""
    from . import env as dist_env
    from .env import build_mesh

    pe = _one_rank()
    if mesh_shape:
        mesh = build_mesh(tuple(mesh_shape.keys()),
                          tuple(mesh_shape.values()))
    else:
        mesh = build_mesh((data_axis,))
    dist_env.set_mesh(mesh)
    dist_env.set_data_axis(data_axis if data_axis in mesh.axis_names else None)
    dist_env.register_ring(0, data_axis)
    return pe


def get_rank() -> int:
    return ParallelEnv().rank


def get_world_size() -> int:
    ws = ParallelEnv().world_size
    if ws > 1:
        return ws
    from . import env as dist_env
    mesh = dist_env.current_mesh()
    if mesh is not None:
        return int(mesh.size)
    return 1
