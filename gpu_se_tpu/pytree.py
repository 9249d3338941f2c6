"""Immutable dataclasses registered as JAX pytrees.

Every state and constant bundle in the package (filter states, mixture
parameters, QP constants and solutions) is one of these: a frozen
dataclass whose fields are pytree leaves in declaration order, with a
``replace(**changes)`` method for functional updates.
"""
from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    """Frozen dataclass + ``jax.tree_util.register_dataclass``.

    All fields are data (leaves), flattened in declaration order;
    ``replace`` returns a copy with the given fields changed.
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)
