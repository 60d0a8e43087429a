"""Device mesh + sharding layout.

Replacement for the reference's Lightning DDP / NCCL stack
(`scripts/train_mmf.py:159-168`, `utils/helpers.py:51-54`): a single
`jax.sharding.Mesh` over the devices with a `data` axis.  Batches are sharded
along `data`; parameters and optimizer state are replicated; the gradient
all-reduce is inserted by the partitioner because the loss is a mean over
the globally sharded batch (no explicit NCCL calls to translate).

Multi-host: each process feeds its local devices via
`jax.make_array_from_process_local_data`; metric sync falls out of jit the
same way gradients do.  `multihost_utils.process_allgather` replaces the
reference's shared-filesystem rank gather for generation
(`utils/callbacks.py:36-58`).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from multimodal_flows.data.state import DataCoupling, MultiModal

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(devices: Optional[list] = None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D data-parallel mesh over all (or the given) devices."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def make_mesh_2d(n_model: int, devices: Optional[list] = None) -> Mesh:
    """(data, model) mesh: the trailing `n_model` devices of each row form
    the tensor-parallel group (the model axis carries the per-layer
    all-reduces)."""
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    assert n % n_model == 0, f"{n} devices not divisible by model={n_model}"
    arr = np.asarray(devices).reshape(n // n_model, n_model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def data_axis_size(mesh: Mesh) -> int:
    """Number of devices on the `data` axis (the whole mesh for a 1-D mesh
    without a named data axis).  Batch divisibility must be asserted
    against this, not `mesh.devices.size` — on a (data, model) 2-D mesh
    the batch shards over `data` only (trainer.py:265 fixed this for fit;
    the generator asserts against the same quantity)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return sizes.get(DATA_AXIS, mesh.devices.size)


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> NamedSharding:
    """Shard the leading (batch) dim over the data axis."""
    return NamedSharding(mesh, P(axis_name))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_coupling(coupling: DataCoupling, mesh: Optional[Mesh]) -> DataCoupling:
    """Device-put a host batch with batch-dim sharding (replicates under a
    trivial/absent mesh).

    Multi-host: every process passes the same *global* batch (all hosts
    compute the same shuffle from the shared seed); this function keeps only
    this process's contiguous rows (`process_batch_slice`) and assembles the
    global array with `jax.make_array_from_process_local_data` — the
    JAX-native version of the reference's per-rank DataLoader sharding
    under DDP.
    """
    if mesh is None:
        return jax.tree.map(jax.numpy.asarray, coupling)
    sharding = batch_sharding(mesh)
    if jax.process_count() == 1:
        return jax.tree.map(lambda a: jax.device_put(a, sharding), coupling)
    return jax.tree.map(
        lambda a: jax.make_array_from_process_local_data(
            sharding, local_batch_shard(np.asarray(a), axis=0)),
        coupling,
    )


def fsdp_sharding(params, mesh: Mesh, min_size: int = 2**12):
    """FSDP-style sharding spec for a parameter pytree: the largest axis of
    every big leaf is sharded over the data axis (optimizer state follows
    the same layout); small leaves stay replicated.

    With `jit` auto-partitioning this yields ZeRO-3 semantics: params and
    Adam moments live sharded in HBM, all-gathers materialize full weights
    per layer during the step, gradients reduce-scatter back.  The
    reference has no equivalent (DDP replicates everything).
    """
    def spec_of(leaf):
        if leaf.ndim == 0 or leaf.size < min_size:
            return NamedSharding(mesh, P())
        axis = int(np.argmax(leaf.shape))
        if leaf.shape[axis] % mesh.devices.size != 0:
            return NamedSharding(mesh, P())
        parts = [None] * leaf.ndim
        parts[axis] = DATA_AXIS
        return NamedSharding(mesh, P(*parts))

    return jax.tree.map(spec_of, params)


#: column-parallel Dense layers (output dim sharded; bias sharded with it)
_TP_COL = ("c_attn", "c_fc", "fc")
#: row-parallel Dense layers (input dim sharded; bias replicated — it adds
#: after the partitioner's all-reduce)
_TP_ROW = ("c_proj", "proj")


def tp_sharding(params, mesh: Mesh, model_axis: str = MODEL_AXIS):
    """Megatron-style tensor-parallel layout for the set-encoder pytrees.

    The encoders already use the Megatron pairing by construction: every
    attention/MLP/head is a column-parallel Dense (`c_attn`, `c_fc`, `fc`)
    feeding a row-parallel Dense (`c_proj`, `proj`).  Sharding just those
    kernels over `model` and letting jit's SPMD partitioner propagate
    yields the classic layout: the intermediate activations shard on the
    hidden dim between the pair and one all-reduce per attention/MLP block
    materializes the row-parallel output (the collectives the reference
    would hand-write with NCCL fall out of the annotations; for `c_attn`
    the partitioner additionally reshards around the packed-qkv split when
    the shard grid does not align with the Q/K/V boundaries).

    LayerNorms, embeddings, and time projections are replicated (they are
    tiny and their inputs are row-replicated).  Any kernel whose sharded
    dim does not divide the axis size falls back to replicated, so the same
    spec works for tiny test models.
    """
    size = mesh.shape[model_axis]

    def spec(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        parent = names[-2] if len(names) >= 2 else ""
        last = names[-1]
        if last == "kernel" and leaf.ndim == 2:
            if parent in _TP_COL and leaf.shape[-1] % size == 0:
                return NamedSharding(mesh, P(None, model_axis))
            if parent in _TP_ROW and leaf.shape[0] % size == 0:
                return NamedSharding(mesh, P(model_axis, None))
        if last == "bias" and leaf.ndim == 1:
            if parent in _TP_COL and leaf.shape[0] % size == 0:
                return NamedSharding(mesh, P(model_axis))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(spec, params)


def process_slice(n: int) -> slice:
    """This process's contiguous share of a length-n global set (host-side
    dataset sharding for multi-host data parallelism)."""
    per = n // jax.process_count()
    i = jax.process_index()
    return slice(i * per, (i + 1) * per if i < jax.process_count() - 1 else n)


def process_batch_slice(n: int, n_proc: Optional[int] = None,
                        idx: Optional[int] = None) -> slice:
    """This process's contiguous rows of a globally `data`-sharded batch
    axis of length n.  Unlike `process_slice` the shares must be exactly
    equal — `make_array_from_process_local_data` requires every process to
    contribute the same extent along a sharded dim.

    Pure given explicit (n_proc, idx), so the multi-host slicing is
    unit-testable without multiple processes.
    """
    n_proc = jax.process_count() if n_proc is None else n_proc
    idx = jax.process_index() if idx is None else idx
    assert n % n_proc == 0, (
        f"global batch axis {n} must divide evenly over {n_proc} processes")
    per = n // n_proc
    return slice(idx * per, (idx + 1) * per)


def local_batch_shard(a: np.ndarray, axis: int, n_proc: Optional[int] = None,
                      idx: Optional[int] = None) -> np.ndarray:
    """Slice this process's rows of `a` along the globally-sharded `axis`
    (the host-side half of `make_array_from_process_local_data`)."""
    sl = [slice(None)] * a.ndim
    sl[axis] = process_batch_slice(a.shape[axis], n_proc, idx)
    return a[tuple(sl)]


def sync_hosts(name: str = "barrier") -> None:
    """Global barrier across hosts (reference used Lightning's
    `trainer.strategy.barrier()`, `utils/callbacks.py:30`)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


def shard_state(state: MultiModal, mesh: Optional[Mesh]) -> MultiModal:
    if mesh is None:
        return state.to_device()
    return state.to_device(batch_sharding(mesh))
