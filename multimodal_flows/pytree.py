"""Immutable dataclasses registered as JAX pytrees.

`dataclass` freezes a class and registers its fields with
`jax.tree_util.register_dataclass`, so instances flow through `jit`,
`scan` and sharding like any pytree; `replace(**kw)` returns a modified
copy.  Subclassing `PyTreeNode` does the same without the decorator.
A field declared with `field(pytree_node=False)` is static metadata.
"""

from __future__ import annotations

import dataclasses


def field(pytree_node: bool = True, **kwargs):
    return dataclasses.field(metadata={"pytree_node": pytree_node}, **kwargs)


def _replace(self, **updates):
    return dataclasses.replace(self, **updates)


def dataclass(cls):
    import jax

    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if f.metadata.get("pytree_node", True)],
        meta_fields=[f.name for f in fields if not f.metadata.get("pytree_node", True)])
    cls.replace = _replace
    return cls


class PyTreeNode:
    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclass(cls)
