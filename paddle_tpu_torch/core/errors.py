"""Typed errors (counterpart of paddle_tpu/core/errors.py).

Only the classes the ported paths raise are copied, with the JAX package's
names and bases, so an ``except`` written against one package reads the
same against the other.
"""
from __future__ import annotations

__all__ = ["EnforceNotMet", "InvalidArgumentError",
           "PreconditionNotMetError", "ResourceExhaustedError",
           "UnimplementedError", "ProgramVerificationError"]


class EnforceNotMet(Exception):
    """Base of the taxonomy (ref enforce.h EnforceNotMet)."""


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    """RESOURCE_EXHAUSTED."""


class InvalidArgumentError(EnforceNotMet, ValueError):
    """error_codes.proto INVALID_ARGUMENT."""


class PreconditionNotMetError(EnforceNotMet, RuntimeError):
    """PRECONDITION_NOT_MET — e.g. running before initialization."""


class UnimplementedError(EnforceNotMet, NotImplementedError):
    """UNIMPLEMENTED."""


class ProgramVerificationError(InvalidArgumentError):
    """A Program failed a check; the findings are on ``.diagnostics``."""

    def __init__(self, message: str = "", diagnostics=()):
        super().__init__(message)
        self.diagnostics = list(diagnostics)
