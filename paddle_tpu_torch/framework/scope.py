"""Scope: name -> tensor store — the counterpart of
``paddle_tpu/framework/scope.py``.

The reference's Scope is a flat name -> ``jax.Array`` map that the
executor rebinds after every run. The port's executor writes a run's new
values into the scope's own tensors (``copy_``) instead, so a captured
CUDA graph can hold them by address across runs. The executor registers
each graph it captures on the scope with the names it holds
(:meth:`_hold`); :meth:`set_var` of such a name copies the new value into
the held tensor when its shape and dtype match, so the next replay reads
it (the reference's ``set_lr`` is a ``set_var`` of the lr variable), and
otherwise drops the graphs that hold it before it rebinds the name.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional

import numpy as np
import torch


class Scope:
    def __init__(self, parent: Optional["Scope"] = None):
        self._vars: Dict[str, object] = {}
        self.parent = parent
        # name -> the executor entries whose graphs hold its tensor
        self._holders: Dict[str, "weakref.WeakSet"] = {}

    def find_var(self, name: str):
        s: Optional[Scope] = self
        while s is not None:
            if name in s._vars:
                return s._vars[name]
            s = s.parent
        return None

    def has_var(self, name: str) -> bool:
        return self.find_var(name) is not None

    def set_var(self, name: str, value):
        """Bind ``name`` to ``value`` (a tensor, or an array the scope
        turns into one on the device of the tensor it replaces). A name a
        live graph holds keeps its tensor: a value of the same shape and
        dtype is copied into it; any other value drops those graphs."""
        old = self._vars.get(name)
        if not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value), device=None
                                    if old is None else old.device)
        holders = self._holders.get(name)
        if old is not None and holders:
            if old.shape == value.shape and old.dtype == value.dtype:
                old.copy_(value)
                return
            self._release(name)
        self._vars[name] = value

    def erase(self, name: str):
        self._release(name)
        self._vars.pop(name, None)

    def var_names(self):
        return list(self._vars.keys())

    def all_var_names(self):
        """All names visible from this scope (own + ancestors)."""
        names = set()
        s: Optional[Scope] = self
        while s is not None:
            names.update(s._vars.keys())
            s = s.parent
        return names

    def new_scope(self) -> "Scope":
        return Scope(parent=self)

    def get_numpy(self, name: str) -> np.ndarray:
        v = self.find_var(name)
        if v is None:
            raise KeyError(f"variable {name!r} not in scope")
        if isinstance(v, torch.Tensor):
            # a copy: later runs write the scope's tensors in place
            v = v.detach()
            if v.dtype == torch.bfloat16:
                v = v.float()
            return v.cpu().numpy().copy()
        return np.array(v)

    # -- graphs that hold the scope's tensors by address -------------------
    def _hold(self, names, entry):
        """Note that ``entry`` (an executor cache entry with a captured
        graph) reads and writes the tensors of ``names`` in place."""
        for n in names:
            self._holders.setdefault(n, weakref.WeakSet()).add(entry)

    def _release(self, name):
        """Drop the graphs that hold ``name``'s tensor."""
        for entry in list(self._holders.pop(name, ())):
            entry.drop_graph()


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope
