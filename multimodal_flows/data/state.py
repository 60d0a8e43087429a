"""Multimodal state containers as JAX pytrees.

Re-design of the reference's `TensorMultiModal` / `DataCoupling`
(see reference `utils/tensorclass.py:12-250`, `utils/datasets.py:8-41`):
instead of a mutable torch dataclass, these are immutable, registered pytrees
(`multimodal_flows.pytree.dataclass`) so they flow through `jit` / `scan` / `pjit`
transparently.  All mutation is by functional `.replace(...)`.

Fields (any may be None):
  time:       (B,)        float  — bridge time per jet
  continuous: (B, D, Fc)  float  — particle kinematics (pt, eta_rel, phi_rel)
  discrete:   (B, D, 1)   int    — flavor tokens in {0..V-1}, 0 = pad
  mask:       (B, D, 1)   int/bool — 1 for real particles
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from multimodal_flows import pytree

Array = jax.Array

_MODES = ("time", "continuous", "discrete", "mask")


def _import_h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading or writing .h5 jet files needs the h5py "
                          "package, which is not installed") from e
    return h5py


@pytree.dataclass
class MultiModal:
    """Immutable multimodal particle-cloud state (pytree)."""

    time: Optional[Array] = None
    continuous: Optional[Array] = None
    discrete: Optional[Array] = None
    mask: Optional[Array] = None

    # ---------------------------------------------------------------- sizes

    def __len__(self) -> int:
        for m in reversed(self.available_modes(include_mask=True)):
            return int(getattr(self, m).shape[0])
        return 0

    @property
    def ndim(self) -> int:
        modes = self.available_modes()
        if not modes:
            return 0
        return getattr(self, modes[-1]).ndim

    @property
    def shape(self):
        modes = self.available_modes()
        if not modes:
            return None
        return getattr(self, modes[-1]).shape[:-1]

    @property
    def num_particles(self) -> Optional[int]:
        """Static max number of particles D (None for per-point states)."""
        for m in ("continuous", "discrete", "mask"):
            v = getattr(self, m)
            if v is not None and v.ndim >= 2:
                return int(v.shape[1])
        return None

    # ---------------------------------------------------------- mode queries

    def available_modes(self, include_mask: bool = False) -> List[str]:
        modes = [m for m in ("time", "continuous", "discrete") if getattr(self, m) is not None]
        if include_mask and self.mask is not None:
            modes.append("mask")
        return modes

    @property
    def has_continuous(self) -> bool:
        return self.continuous is not None

    @property
    def has_discrete(self) -> bool:
        return self.discrete is not None

    # ------------------------------------------------------------ transforms

    def map(self, fn: Callable[[Array], Array]) -> "MultiModal":
        """Apply `fn` to every non-None field (reference `_apply_fn`)."""
        return MultiModal(
            time=fn(self.time) if self.time is not None else None,
            continuous=fn(self.continuous) if self.continuous is not None else None,
            discrete=fn(self.discrete) if self.discrete is not None else None,
            mask=fn(self.mask) if self.mask is not None else None,
        )

    def __getitem__(self, index) -> "MultiModal":
        return self.map(lambda a: a[index])

    def astype_numpy(self) -> "MultiModal":
        return self.map(np.asarray)

    def to_device(self, sharding=None) -> "MultiModal":
        if sharding is None:
            return self.map(jnp.asarray)
        return self.map(lambda a: jax.device_put(a, sharding))

    def apply_mask(self, condition: Optional[Array] = None) -> "MultiModal":
        """Zero out padded entries; discrete is cast to int (reference
        `tensorclass.py:97-108`)."""
        cond = self.mask if condition is None else condition
        new_continuous = self.continuous
        new_discrete = self.discrete
        if self.continuous is not None:
            new_continuous = self.continuous * cond
        if self.discrete is not None:
            new_discrete = (self.discrete * cond).astype(jnp.int32)
        return self.replace(continuous=new_continuous, discrete=new_discrete)

    # ------------------------------------------------------------- stitching

    @staticmethod
    def concat(states: Sequence["MultiModal"], axis: int = 0) -> "MultiModal":
        def cat_attr(name):
            attrs = [getattr(s, name) for s in states if getattr(s, name) is not None]
            if not attrs:
                return None
            return jnp.concatenate(attrs, axis=axis)

        return MultiModal(
            time=cat_attr("time"),
            continuous=cat_attr("continuous"),
            discrete=cat_attr("discrete"),
            mask=cat_attr("mask"),
        )

    @staticmethod
    def stack(states: Sequence["MultiModal"], axis: int = 0) -> "MultiModal":
        def stack_attr(name):
            attrs = [getattr(s, name) for s in states if getattr(s, name) is not None]
            if not attrs:
                return None
            return jnp.stack(attrs, axis=axis)

        return MultiModal(
            time=stack_attr("time"),
            continuous=stack_attr("continuous"),
            discrete=stack_attr("discrete"),
            mask=stack_attr("mask"),
        )

    # -------------------------------------------------------------- HDF5 I/O

    def save_to(self, path: str) -> None:
        """Write fields to an HDF5 file (reference `tensorclass.py:197-201`).

        Atomic: writes to a sibling tmp file then renames, so a crash
        mid-write never leaves a truncated/corrupt .h5 that a resume pass
        then trips over."""
        h5py = _import_h5py()

        tmp = path + ".tmp"
        with h5py.File(tmp, "w") as f:
            for mode in _MODES:
                v = getattr(self, mode)
                if v is not None:
                    f.create_dataset(mode, data=np.asarray(v))
        os.replace(tmp, path)

    @classmethod
    def load_from(cls, path: str, transform=None) -> "MultiModal":
        """Load fields from an HDF5 file (reference `tensorclass.py:110-149`).

        `transform` may be a callable applied to every array or a dict of
        per-field callables.
        """
        h5py = _import_h5py()

        arrays = {}
        with h5py.File(path, "r") as f:
            for mode in _MODES:
                arrays[mode] = np.asarray(f[mode]) if mode in f else None

        if transform is not None:
            if callable(transform):
                arrays = {k: (transform(v) if v is not None else None) for k, v in arrays.items()}
            elif isinstance(transform, dict):
                for k, fn in transform.items():
                    if arrays.get(k) is not None and callable(fn):
                        arrays[k] = fn(arrays[k])

        return cls(**arrays)


@pytree.dataclass
class DataCoupling:
    """(source, target, context) triple — the unit flowing through training
    and sampling (reference `utils/datasets.py:8-41`)."""

    source: MultiModal = pytree.field(default_factory=MultiModal)
    target: MultiModal = pytree.field(default_factory=MultiModal)
    context: MultiModal = pytree.field(default_factory=MultiModal)

    def __len__(self) -> int:
        n = len(self.target)
        return n if n else len(self.source)

    @property
    def shape(self):
        return self.target.shape

    @property
    def has_source(self) -> bool:
        return bool(self.source.available_modes(include_mask=True))

    @property
    def has_target(self) -> bool:
        return bool(self.target.available_modes(include_mask=True))

    @property
    def has_context(self) -> bool:
        return bool(self.context.available_modes(include_mask=True))

    def __getitem__(self, index) -> "DataCoupling":
        return DataCoupling(
            source=self.source[index] if self.has_source else MultiModal(),
            target=self.target[index] if self.has_target else MultiModal(),
            context=self.context[index] if self.has_context else MultiModal(),
        )
