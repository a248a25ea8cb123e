"""Fleet utilities (the counterpart of
``paddle_tpu/distributed/fleet/utils``). ``recompute`` runs a dygraph
segment on the tape and waits for ROADMAP A7.5; the filesystem shell
(``fs``: ``LocalFS``, ``HDFSClient``) and the KV HTTP server
(``http_server``: ``KVServer``, ``KVClient``) wait for A7.4. The static
plane's recompute is :class:`~paddle_tpu_torch.optimizer.RecomputeOptimizer`."""

from __future__ import annotations

from typing import Callable

_A74 = ("fs", "http_server", "LocalFS", "HDFSClient", "KVClient",
        "KVServer")


def recompute(function: Callable, *args, preserve_rng_state: bool = True):
    """fleet.utils.recompute (``paddle_tpu/distributed/fleet/utils/
    recompute.py:75``): waits for the dygraph tape."""
    raise NotImplementedError(
        "fleet.utils.recompute runs on the dygraph tape and waits for "
        "ROADMAP A7.5; a static Program recomputes through "
        "RecomputeOptimizer")


def __getattr__(name):
    if name in _A74:
        raise NotImplementedError(
            f"fleet.utils.{name} waits for ROADMAP A7.4")
    raise AttributeError(name)
