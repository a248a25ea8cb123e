"""Distributed environment state — the counterpart of
``paddle_tpu/distributed/env.py``: the active mesh, its data axis and the
ring map (ring id -> mesh axis name) that collective ops and the fleet
read.

The reference's mesh is a ``jax.sharding.Mesh`` over every chip. The
port runs one rank: :func:`build_mesh` builds a :class:`Mesh` over one
device (the card, or the CPU when asked), whose every axis has size 1.
A mesh over more devices, and the collectives it would carry, wait for
ROADMAP A5.
"""

from __future__ import annotations

from typing import Dict, Optional

# ring_id -> mesh axis name; populated by init_parallel_env / fleet
_ring_to_axis: Dict[int, str] = {}
_data_axis: Optional[str] = None
_mesh = None


class Mesh:
    """A one-device mesh: ``axis_names``, ``shape`` (axis name -> 1, as
    ``jax.sharding.Mesh.shape`` maps names to sizes), ``devices`` and
    ``size``."""

    def __init__(self, device, axis_names):
        self.axis_names = tuple(axis_names)
        self.shape = {a: 1 for a in self.axis_names}
        self.devices = [device]
        self.size = 1

    def __repr__(self):
        return f"Mesh({self.shape}, device={self.devices[0]})"


def register_ring(ring_id: int, axis_name: str):
    _ring_to_axis[int(ring_id)] = axis_name


def axis_for_ring(ring_id: int) -> Optional[str]:
    return _ring_to_axis.get(int(ring_id))


def set_data_axis(axis_name: Optional[str]):
    global _data_axis
    _data_axis = axis_name


def current_data_axis() -> Optional[str]:
    return _data_axis


def set_mesh(mesh):
    global _mesh
    _mesh = mesh


def current_mesh():
    return _mesh


def build_mesh(axis_names, shape=None, *, devices=None):
    """The mesh of ``axis_names`` over one device: ``devices`` (one
    entry; the card by default) and ``shape`` (every size 1, or -1).
    More than one device, or an axis longer than 1, raises
    NotImplementedError naming ROADMAP A5."""
    import torch

    axis_names = tuple(axis_names)
    shape = [1] * len(axis_names) if shape is None else \
        [int(s) for s in shape]
    if len(shape) != len(axis_names):
        raise ValueError("shape/axis_names length mismatch")
    if devices is None:
        devices = [torch.device("cuda", 0)]
    devices = list(devices)
    if len(devices) != 1 or any(s not in (1, -1) for s in shape):
        raise NotImplementedError(
            f"a mesh over {len(devices)} devices with axis sizes "
            f"{tuple(shape)}: the port runs one rank; meshes over more "
            "cards and their collectives wait for ROADMAP A5")
    return Mesh(torch.device(devices[0]), axis_names)
