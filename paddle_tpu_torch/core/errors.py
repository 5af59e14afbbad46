"""Typed errors (counterpart of paddle_tpu/core/errors.py).

Only the classes the ported paths raise are copied, with the JAX package's
names and bases, so an ``except`` written against one package reads the
same against the other.
"""
from __future__ import annotations

__all__ = ["EnforceNotMet", "ResourceExhaustedError"]


class EnforceNotMet(Exception):
    """Base of the taxonomy (ref enforce.h EnforceNotMet)."""


class ResourceExhaustedError(EnforceNotMet, MemoryError):
    """RESOURCE_EXHAUSTED."""
