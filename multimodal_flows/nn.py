"""Minimal neural-network modules: parameter pytrees behind init/apply.

The models are written as modules that declare their layers inline: a
module is a dataclass of hyper-parameters whose methods create sub-modules
and parameters as they run.  `Module.init(key, *args)` runs a method once
and returns the parameters it created, as the nested dict
``{"params": {module_name: {...}}}``; `Module.apply(variables, *args)` runs
a method against such a tree.  The parameters are a plain pytree of arrays
for optax, sharding and checkpoints; no state lives in the module objects.

A sub-module is named by its `name=` argument, else by the attribute it is
assigned to in `setup()`, else `<ClassName>_<n>` in creation order within
one call of its parent.  Random keys ("params" at init, "dropout" when
given to apply) are folded with the module's path and a per-module counter,
so every parameter and dropout mask draws its own key.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import threading
import types
import zlib
from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

Array = jax.Array

gelu = jax.nn.gelu
relu = jax.nn.relu
silu = jax.nn.silu
leaky_relu = jax.nn.leaky_relu


def _normal(stddev: float = 1e-2):
    def init(key, shape, dtype=jnp.float32):
        return jax.random.normal(key, shape, dtype) * stddev
    return init


def _zeros(key, shape, dtype=jnp.float32):
    return jnp.zeros(shape, dtype)


def _ones(key, shape, dtype=jnp.float32):
    return jnp.ones(shape, dtype)


initializers = types.SimpleNamespace(normal=_normal, zeros=_zeros, ones=_ones)


class _Root:
    """The variables and random keys of one init/apply call."""

    def __init__(self, params: dict, rngs: dict, initializing: bool):
        self.params = params
        self.rngs = rngs
        self.initializing = initializing


class _Scope:
    """A module's place in the parameter tree of one init/apply call."""

    def __init__(self, root: _Root, path: tuple):
        self.root = root
        self.path = path
        self.name_counts: dict = {}
        self.rng_counts: dict = {}

    def child(self, name: str) -> "_Scope":
        return _Scope(self.root, self.path + (name,))

    def auto_name(self, prefix: str) -> str:
        n = self.name_counts.get(prefix, 0)
        self.name_counts[prefix] = n + 1
        return f"{prefix}_{n}"

    def _params(self, create: bool) -> Optional[dict]:
        d = self.root.params
        for name in self.path:
            if name not in d:
                if not create:
                    return None
                d[name] = {}
            d = d[name]
        return d

    def param(self, name: str, init_fn: Callable, *args):
        d = self._params(create=False)
        if d is not None and name in d:
            return d[name]
        if not self.root.initializing:
            raise KeyError(f"parameter {'/'.join(self.path + (name,))!r} not found")
        value = init_fn(self.make_rng("params"), *args)
        self._params(create=True)[name] = value
        return value

    def make_rng(self, stream: str):
        key = self.root.rngs.get(stream)
        if key is None:
            raise ValueError(f"no {stream!r} random key was given to init/apply")
        n = self.rng_counts.get(stream, 0)
        self.rng_counts[stream] = n + 1
        path_id = zlib.crc32("/".join(self.path).encode()) & 0x7FFFFFFF
        return jax.random.fold_in(jax.random.fold_in(key, path_id), n)


_context = threading.local()


def _frames() -> list:
    """(scope, in_setup) of the module methods running in this thread."""
    if not hasattr(_context, "frames"):
        _context.frames = []
    return _context.frames


def _module_method(fn):
    """Run `fn` with its module bound and on the frame stack, so modules it
    creates become its children."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        self._bind()
        if self._depth == 0:
            # sub-modules created inline get the same names on every call
            self._scope.name_counts.clear()
        self._depth += 1
        _frames().append((self._scope, False))
        try:
            return fn(self, *args, **kwargs)
        finally:
            _frames().pop()
            self._depth -= 1

    wrapped._module_method = True
    return wrapped


_NOT_WRAPPED = ("setup", "init", "apply", "param", "make_rng")


@dataclasses.dataclass(eq=False)
class Module:
    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = cls.__dict__.get("__annotations__", {})
        for attr, fn in list(vars(cls).items()):
            if (isinstance(fn, types.FunctionType) and attr not in _NOT_WRAPPED
                    and attr not in fields
                    and (attr == "__call__" or not attr.startswith("_"))
                    and not getattr(fn, "_module_method", False)):
                setattr(cls, attr, _module_method(fn))
        dataclasses.dataclass(eq=False)(cls)

    def __post_init__(self):
        self._scope = None
        self._ready = False
        self._depth = 0
        frames = _frames()
        self._parent_scope = frames[-1][0] if frames else None
        if self._parent_scope is not None and self.name is None and not frames[-1][1]:
            self.name = self._parent_scope.auto_name(type(self).__name__)

    def setup(self) -> None:
        """Create sub-modules as attributes (named after the attribute)."""

    def _bind(self) -> None:
        if self._scope is None:
            if self._parent_scope is None:
                raise RuntimeError(f"{type(self).__name__} is not bound: "
                                   "call it through init() or apply()")
            self._scope = self._parent_scope.child(self.name)
        if self._ready:
            return
        self._ready = True
        _frames().append((self._scope, True))
        try:
            self.setup()
        finally:
            _frames().pop()
        for attr, value in list(vars(self).items()):
            if isinstance(value, Module) and value.name is None:
                value.name = attr
            elif isinstance(value, (list, tuple)):
                for i, v in enumerate(value):
                    if isinstance(v, Module) and v.name is None:
                        v.name = f"{attr}_{i}"

    def param(self, name: str, init_fn: Callable, *args):
        return self._scope.param(name, init_fn, *args)

    def make_rng(self, stream: str = "params"):
        return self._scope.make_rng(stream)

    @property
    def is_initializing(self) -> bool:
        return self._scope.root.initializing

    def _run(self, params: dict, rngs, initializing: bool, method, args, kwargs):
        if rngs is None:
            rngs = {}
        elif not isinstance(rngs, dict):
            rngs = {"params": rngs}
        module = copy.copy(self)
        module._scope = _Scope(_Root(params, dict(rngs), initializing), ())
        module._ready = False
        module._depth = 0
        if method is None:
            return module(*args, **kwargs)
        if isinstance(method, str):
            return getattr(module, method)(*args, **kwargs)
        return method(module, *args, **kwargs)

    def init(self, rngs, *args, method=None, **kwargs) -> dict:
        """Run `method` (default `__call__`) and return the parameters it
        created.  `rngs` is a key (for the "params" stream) or a dict."""
        params: dict = {}
        self._run(params, rngs, True, method, args, kwargs)
        return {"params": params}

    def apply(self, variables: dict, *args, rngs=None, method=None, **kwargs):
        """Run `method` (default `__call__`) with the given parameters."""
        return self._run(variables["params"], rngs, False, method, args, kwargs)


def remat(module_cls, static_argnums=()):
    """`module_cls` with `__call__` under `jax.checkpoint`: its activations
    are recomputed in the backward pass.  `static_argnums` count `self` as
    0.  Initialisation runs un-checkpointed, since it creates parameters."""

    class Remat(module_cls):
        def __call__(self, *args):
            call = functools.partial(module_cls.__call__, self)
            if self.is_initializing:
                return call(*args)
            static = tuple(i - 1 for i in static_argnums)
            return jax.checkpoint(call, static_argnums=static)(*args)

    Remat.__name__ = Remat.__qualname__ = module_cls.__name__
    return Remat


class Dense(Module):
    """y = x @ kernel + bias over the last axis; computed in `dtype` (by
    default the promoted type of input and kernel), parameters in fp32."""

    features: int
    use_bias: bool = True
    kernel_init: Callable = _normal(0.02)
    bias_init: Callable = _zeros
    dtype: Any = None

    def __call__(self, x: Array) -> Array:
        kernel = self.param("kernel", self.kernel_init, (x.shape[-1], self.features),
                            jnp.float32)
        dtype = self.dtype or jnp.result_type(x, kernel)
        y = jax.lax.dot_general(x.astype(dtype), kernel.astype(dtype),
                                (((x.ndim - 1,), (0,)), ((), ())))
        if self.use_bias:
            y = y + self.param("bias", self.bias_init, (self.features,),
                               jnp.float32).astype(dtype)
        return y


class LayerNorm(Module):
    """Layer normalisation over the last axis; statistics in fp32."""

    epsilon: float = 1e-6
    dtype: Any = None
    use_bias: bool = True
    use_scale: bool = True

    def __call__(self, x: Array) -> Array:
        features = x.shape[-1]
        xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
        mean = xf.mean(-1, keepdims=True)
        var = jnp.square(xf - mean).mean(-1, keepdims=True)
        y = (xf - mean) * jax.lax.rsqrt(var + self.epsilon)
        if self.use_scale:
            y = y * self.param("scale", _ones, (features,), jnp.float32)
        if self.use_bias:
            y = y + self.param("bias", _zeros, (features,), jnp.float32)
        return y.astype(self.dtype or jnp.result_type(x.dtype, jnp.float32))


class Embed(Module):
    """Lookup table of `num_embeddings` rows of width `features`."""

    num_embeddings: int
    features: int
    embedding_init: Callable = _normal(0.02)
    dtype: Any = None

    def __call__(self, idx: Array) -> Array:
        table = self.param("embedding", self.embedding_init,
                           (self.num_embeddings, self.features), jnp.float32)
        if self.dtype is not None:
            table = table.astype(self.dtype)
        return jnp.take(table, idx, axis=0)


class Dropout(Module):
    """Inverted dropout with the "dropout" random stream; the identity when
    deterministic or at rate 0."""

    rate: float
    deterministic: Optional[bool] = None

    def __call__(self, x: Array, deterministic: Optional[bool] = None) -> Array:
        if deterministic is None:
            deterministic = self.deterministic
        if deterministic is None:
            raise ValueError("Dropout needs `deterministic` at construction or call")
        if self.rate == 0.0 or deterministic:
            return x
        if self.rate >= 1.0:
            return jnp.zeros_like(x)
        keep = jax.random.bernoulli(self.make_rng("dropout"), 1.0 - self.rate, x.shape)
        return jnp.where(keep, x / (1.0 - self.rate), jnp.zeros_like(x))
