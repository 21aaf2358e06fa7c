"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` makes an immutable dataclass, registers it with
``jax.tree_util.register_dataclass`` and gives it a ``.replace(**changes)``
method.  Fields are pytree leaves unless declared with
``field(pytree_node=False)``, which puts them in the tree structure instead:
they must be hashable, are static under ``jit``, and a change of value is a
new trace.
"""
from __future__ import annotations

import dataclasses

import jax

__all__ = ["dataclass", "field"]


def field(pytree_node: bool = True, **kwargs):
    """``dataclasses.field`` that records whether the field is a leaf."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass registered as a pytree (see the module docstring)."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(f.name)
    jax.tree_util.register_dataclass(cls, data_fields=data, meta_fields=meta)
    cls.replace = _replace
    return cls
