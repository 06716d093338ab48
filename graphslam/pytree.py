"""Frozen dataclasses that are JAX pytrees.

`pytree_dataclass` turns a class body into a frozen dataclass registered with
`jax.tree_util.register_dataclass`, and gives it `.replace(**changes)`.
Fields declared with `static_field` are compile-time metadata: they ride in
the treedef, so a new value retraces a jitted function instead of becoming a
traced array.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(default=dataclasses.MISSING):
    return dataclasses.field(default=default, metadata={"static": True})


def pytree_dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)
