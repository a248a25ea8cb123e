"""Fleet utilities (the counterpart of
``paddle_tpu/distributed/fleet/utils``): the filesystem shell (``fs``:
``LocalFS``, ``HDFSClient``) and the KV HTTP server (``http_server``:
``KVServer``, ``KVClient``). ``recompute`` runs a dygraph segment on the
tape and waits for ROADMAP A7.5b; the static plane's recompute is
:class:`~paddle_tpu_torch.optimizer.RecomputeOptimizer`."""

from __future__ import annotations

from typing import Callable

from . import fs
from .fs import HDFSClient, LocalFS
from . import http_server
from .http_server import KVClient, KVServer


def recompute(function: Callable, *args, preserve_rng_state: bool = True):
    """fleet.utils.recompute (``paddle_tpu/distributed/fleet/utils/
    recompute.py:75``): waits for the dygraph tape."""
    raise NotImplementedError(
        "fleet.utils.recompute runs on the dygraph tape and waits for "
        "ROADMAP A7.5b; a static Program recomputes through "
        "RecomputeOptimizer")
