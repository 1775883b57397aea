"""Frozen dataclasses registered as JAX pytrees.

``@dataclass`` makes a frozen dataclass whose fields are pytree children,
except those declared with ``field(pytree_node=False)``, which become static
metadata (hashable, part of the jit cache key).  Instances get a
``replace(**changes)`` method.
"""
from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """dataclasses.field with a ``pytree_node`` flag (False = static metadata)."""
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = dataclasses.replace
    return cls
