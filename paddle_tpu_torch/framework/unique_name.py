"""Unique name generator (analog of python/paddle/fluid/unique_name.py),
a verbatim copy of ``paddle_tpu/framework/unique_name.py``."""

from __future__ import annotations

import contextlib
from collections import defaultdict


class UniqueNameGenerator:
    def __init__(self, prefix: str = ""):
        self.prefix = prefix
        self.ids = defaultdict(int)

    def __call__(self, key: str) -> str:
        tmp = self.ids[key]
        self.ids[key] += 1
        return f"{self.prefix}{key}_{tmp}"


_generator = UniqueNameGenerator()
_name_scopes = [""]


def generate(key: str) -> str:
    scope = _name_scopes[-1]
    name = _generator(scope + key if scope else key)
    return name


@contextlib.contextmanager
def guard(prefix: str = ""):
    """Fresh name space (used by Program construction contexts / tests)."""
    global _generator
    prev = _generator
    _generator = UniqueNameGenerator(prefix)
    try:
        yield
    finally:
        _generator = prev


@contextlib.contextmanager
def name_scope(name: str):
    _name_scopes.append(_name_scopes[-1] + name + "/")
    try:
        yield
    finally:
        _name_scopes.pop()
