"""Frozen dataclasses registered as JAX pytrees.

`pytree_dataclass` turns a class into a frozen dataclass whose fields are
pytree children, except those declared with `static_field`: those become
pytree metadata (part of the treedef), so jit specializes on their values
and a change to one retraces. Every instance gets a `.replace(**changes)`
method, the functional update the scene code uses throughout.
"""
from __future__ import annotations

import dataclasses

import jax


def static_field(default=dataclasses.MISSING):
    """A dataclass field kept out of the pytree leaves (jit-static)."""
    return dataclasses.field(default=default, metadata={"static": True})


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
