"""Frozen dataclasses registered as JAX pytrees.

`dataclass` turns a class into a frozen `dataclasses.dataclass` whose
fields are all pytree leaves (`jax.tree_util.register_dataclass`), with a
``replace(**changes)`` method (`dataclasses.replace`).  Model parameter
and prior containers use it, so they flatten, jit, vmap and shard like
any other pytree.
"""
from __future__ import annotations

import dataclasses

import jax


def dataclass(cls):
    """Decorate ``cls`` as a frozen dataclass pytree with ``.replace``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(cls, data_fields=names,
                                            meta_fields=[])
