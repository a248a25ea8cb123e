"""Typed error system — the PADDLE_ENFORCE plane; the port's copy of
``paddle_tpu/enforce.py``.

Analog of paddle/fluid/platform/enforce.h:323-416 + errors.h +
error_codes.proto: typed exception classes with an error-code taxonomy
and enforce_* check helpers that raise them with context. The reference
attaches C++ stack traces; python tracebacks serve that role here.
"""

from __future__ import annotations

from typing import Any, NoReturn


class EnforceNotMet(RuntimeError):
    """Base (enforce.h EnforceNotMet)."""
    code = "LEGACY"

    def __str__(self):
        # bypass KeyError.__str__ (repr of args[0]) for the NOT_FOUND
        # subclass so every typed error prints its message uniformly
        return Exception.__str__(self)


class InvalidArgumentError(EnforceNotMet, ValueError):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceNotMet, KeyError):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceNotMet, IndexError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceNotMet):
    code = "ALREADY_EXISTS"


class PermissionDeniedError(EnforceNotMet):
    code = "PERMISSION_DENIED"


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceNotMet):
    code = "PRECONDITION_NOT_MET"


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceNotMet, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceNotMet):
    code = "UNAVAILABLE"


def _raise(exc_cls, msg: str, *args) -> NoReturn:
    code = getattr(exc_cls, "code", exc_cls.__name__)
    raise exc_cls(f"[{code}] " + (msg % args if args else msg))


def enforce(cond: Any, msg: str = "enforce failed", *args,
            exc=EnforceNotMet):
    """PADDLE_ENFORCE(cond, msg) analog."""
    if not cond:
        _raise(exc, msg, *args)


def enforce_eq(a, b, msg: str = "", *args):
    if a != b:
        _cmp_raise("==", a, b, msg, args)


def _cmp_raise(rel: str, a, b, msg: str, args) -> NoReturn:
    detail = (msg % args if args else msg) if msg else ""
    _raise(InvalidArgumentError,
           f"expected {a!r} {rel} {b!r}" + (f"; {detail}" if detail else ""))


def enforce_ne(a, b, msg: str = "", *args):
    if a == b:
        _cmp_raise("!=", a, b, msg, args)


def enforce_gt(a, b, msg: str = "", *args):
    if not a > b:
        _cmp_raise(">", a, b, msg, args)


def enforce_ge(a, b, msg: str = "", *args):
    if not a >= b:
        _cmp_raise(">=", a, b, msg, args)


def enforce_lt(a, b, msg: str = "", *args):
    if not a < b:
        _cmp_raise("<", a, b, msg, args)


def enforce_le(a, b, msg: str = "", *args):
    if not a <= b:
        _cmp_raise("<=", a, b, msg, args)


def enforce_not_none(v, name: str = "value"):
    if v is None:
        _raise(NotFoundError, f"{name} must not be None")
    return v
