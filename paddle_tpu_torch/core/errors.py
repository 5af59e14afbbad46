"""Typed errors (counterpart of paddle_tpu/core/errors.py; ref
``platform/errors.h`` + ``error_codes.proto``).

The JAX package's classes with its names and bases: each subclasses the
builtin exception a caller would already catch (ValueError, KeyError,
...), so an ``except`` written against one package reads the same against
the other, typed or duck-typed.
"""
from __future__ import annotations

__all__ = [
    "EnforceNotMet", "InvalidArgumentError", "NotFoundError",
    "OutOfRangeError", "AlreadyExistsError", "ResourceExhaustedError",
    "PreconditionNotMetError", "StaleScopeValueError",
    "PermissionDeniedError",
    "ExecutionTimeoutError", "UnimplementedError", "UnavailableError",
    "FatalError", "ExternalError", "ProgramVerificationError",
    "render_diagnostics", "enforce",
]


class EnforceNotMet(Exception):
    """Base of the taxonomy (ref enforce.h EnforceNotMet)."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    """error_codes.proto INVALID_ARGUMENT."""


class NotFoundError(EnforceNotMet, KeyError):
    """NOT_FOUND — a requested entity (variable, file, op) is missing."""


class OutOfRangeError(EnforceNotMet, IndexError):
    """OUT_OF_RANGE."""


class AlreadyExistsError(EnforceNotMet, ValueError):
    """ALREADY_EXISTS."""


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    """RESOURCE_EXHAUSTED."""


class PreconditionNotMetError(EnforceNotMet, RuntimeError):
    """PRECONDITION_NOT_MET — e.g. running before initialization."""


class StaleScopeValueError(PreconditionNotMetError):
    """A Scope read returned a value that a compiled step has since
    consumed; the live value is in the scope the step ran on."""


class PermissionDeniedError(EnforceNotMet, PermissionError):
    """PERMISSION_DENIED."""


class ExecutionTimeoutError(EnforceNotMet, TimeoutError):
    """EXECUTION_TIMEOUT."""


class UnimplementedError(EnforceNotMet, NotImplementedError):
    """UNIMPLEMENTED."""


class UnavailableError(EnforceNotMet, RuntimeError):
    """UNAVAILABLE — transient service/backend failure."""


class FatalError(EnforceNotMet, RuntimeError):
    """FATAL."""


class ExternalError(EnforceNotMet, RuntimeError):
    """EXTERNAL — an error surfaced from an external library (CUDA,
    cuDNN)."""


class ProgramVerificationError(InvalidArgumentError):
    """A Program failed a check; the structured findings (objects with
    code / severity / block / op_index / op_type / var / message / hint)
    are on ``.diagnostics``."""

    def __init__(self, message: str = "", diagnostics=()):
        super().__init__(message)
        self.diagnostics = list(diagnostics)


def render_diagnostics(diags) -> str:
    """Render verifier diagnostics one per line:

        PV001 error   [block 0 op 3 mul] message (hint: ...)
    """
    lines = []
    for d in diags:
        loc = f"block {d.block}"
        if d.op_index is not None:
            loc += f" op {d.op_index}"
        if d.op_type:
            loc += f" {d.op_type}"
        line = f"{d.code} {d.severity:<7} [{loc}] {d.message}"
        if d.hint:
            line += f" (hint: {d.hint})"
        lines.append(line)
    return "\n".join(lines)


def enforce(cond, error_cls=InvalidArgumentError, message="enforce failed"):
    """PADDLE_ENFORCE equivalent: raise a typed error when cond is false."""
    if not cond:
        raise error_cls(message)
