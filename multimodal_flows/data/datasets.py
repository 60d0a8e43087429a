"""Host-side dataset plumbing: in-memory couplings, shuffled batch streams,
and set<->sequence helpers.

Replacement for the reference's torch `Dataset`/`DataLoader` stack
(reference `utils/datasets.py:43-142`): data lives in pinned host numpy
arrays; each step slices a static-shape batch and `device_put`s it with the
data-parallel sharding.  No worker processes are needed — featurization is
vectorized numpy and batches are O(MBs).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from multimodal_flows.data.state import DataCoupling, MultiModal


def _np(x):
    return None if x is None else np.asarray(x)


@dataclass
class ArrayDataset:
    """An in-memory DataCoupling of numpy arrays with static shapes.

    Mirrors the role of the reference `MultiModalDataset` +
    `data_coupling_collate_fn` (`utils/datasets.py:43-142`), but batches are
    produced by slicing, not per-item collation.
    """

    coupling: DataCoupling

    def __post_init__(self):
        self.coupling = DataCoupling(
            source=self.coupling.source.map(_np) if self.coupling.has_source else MultiModal(),
            target=self.coupling.target.map(_np) if self.coupling.has_target else MultiModal(),
            context=self.coupling.context.map(_np) if self.coupling.has_context else MultiModal(),
        )

    def __len__(self) -> int:
        return len(self.coupling)

    def __getitem__(self, idx) -> DataCoupling:
        return self.coupling[idx]

    def split(self, train_frac: float, seed: int = 0) -> Tuple["ArrayDataset", "ArrayDataset"]:
        """Random train/val split (reference `train_mmf.py:103-105`)."""
        n = len(self)
        rng = np.random.default_rng(seed)
        perm = rng.permutation(n)
        n_train = int(train_frac * n)
        return (
            ArrayDataset(self.coupling[perm[:n_train]]),
            ArrayDataset(self.coupling[perm[n_train:]]),
        )


def shuffle_batches(
    dataset: ArrayDataset,
    batch_size: int,
    *,
    shuffle: bool = True,
    seed: int = 0,
    epoch: int = 0,
    drop_last: bool = True,
    pad_last: bool = False,
) -> Iterator[DataCoupling]:
    """Yield static-shape DataCoupling batches.

    With `pad_last`, the final partial batch is padded by repeating rows so
    every batch compiles to the same shape (callers use the per-row mask /
    a returned count to discard padding).
    """
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        rng.shuffle(idx)

    num_full = n // batch_size
    for b in range(num_full):
        yield dataset[idx[b * batch_size : (b + 1) * batch_size]]

    rem = n - num_full * batch_size
    if rem and not drop_last:
        tail = idx[num_full * batch_size :]
        if pad_last:
            reps = math.ceil(batch_size / rem)
            tail = np.tile(tail, reps)[:batch_size]
        yield dataset[tail]


def num_batches(n: int, batch_size: int, drop_last: bool = True) -> int:
    return n // batch_size if drop_last else math.ceil(n / batch_size)


def make_train_val_loaders(coupling: DataCoupling, train_frac: float, seed: int = 0):
    """Split a coupling into (train_dataset, val_dataset)."""
    return ArrayDataset(coupling).split(train_frac, seed=seed)


# --------------------------------------------------------------------------
# set <-> sequence helpers (for the autoregressive GPT baseline)
# --------------------------------------------------------------------------


def standardize(jets: MultiModal) -> Tuple[MultiModal, dict]:
    """Standardize continuous features; returns (jets, {'mean','std'}).

    Functional version of reference `utils/datasets.py:145-156`.
    """
    x = np.asarray(jets.continuous, dtype=np.float64)
    dim = x.shape[-1]
    flat = x.reshape(-1, dim)
    mean = flat.mean(axis=0)
    std = flat.std(axis=0, ddof=1)
    out = ((x - mean) / std).astype(np.float32)
    return jets.replace(continuous=out), {"mean": mean.tolist(), "std": std.tolist()}


def jet_set_to_seq(part_set: MultiModal, vocab_size: int) -> MultiModal:
    """Convert a particle set to a BOS/EOS/PAD token sequence for the GPT
    baseline (reference `utils/datasets.py:159-197`).

    start_token = vocab_size + 1, end_token = vocab_size + 2,
    pad_token = vocab_size + 3.
    """
    start_token = vocab_size + 1
    end_token = vocab_size + 2
    pad_token = vocab_size + 3

    if part_set.discrete is None:
        raise ValueError("particle set must have a 'discrete' field")

    seq = np.asarray(part_set.discrete)
    if seq.ndim == 3:
        seq = seq[..., 0]
    seq = seq.copy().astype(np.int64)  # (N, D)
    n = seq.shape[0]

    start = np.full((n, 1), start_token, dtype=np.int64)
    extra_pad = np.full((n, 1), pad_token, dtype=np.int64)
    seq[seq == 0] = pad_token
    seq = np.concatenate([start, seq, extra_pad], axis=1)

    idx_eos = (seq != pad_token).sum(axis=1)
    seq[np.arange(n), idx_eos] = end_token

    mask = (seq != pad_token).astype(np.int32)
    return part_set.replace(discrete=seq, mask=mask)


def seq_to_jet_set(seq: np.ndarray, vocab_size: int, max_num_particles: int) -> np.ndarray:
    """Strip BOS/EOS/PAD special tokens and re-pad to (N, D) flavor tokens."""
    start_token = vocab_size + 1
    seq = np.asarray(seq)
    seq = np.where(seq >= start_token, 0, seq)
    body = seq[:, 1:]  # drop BOS
    out = np.zeros((seq.shape[0], max_num_particles), dtype=np.int64)
    ncols = min(max_num_particles, body.shape[1])
    out[:, :ncols] = body[:, :ncols]
    return out


def pt_order(state: MultiModal, include_mask: bool = False) -> MultiModal:
    """Re-sort particles within each jet by descending pt (feature 0)
    (reference `utils/datasets.py:201-213`)."""
    assert state.has_continuous, "state must have continuous features to sort by pt"
    x = np.asarray(state.continuous)
    order = np.argsort(-x[..., 0], axis=1, kind="stable")
    rows = np.arange(x.shape[0])[:, None]

    new_continuous = x[rows, order]
    new_discrete = state.discrete
    new_mask = state.mask
    if state.has_discrete:
        new_discrete = np.asarray(state.discrete)[rows, order]
    if include_mask and state.mask is not None:
        new_mask = np.asarray(state.mask)[rows, order]
    return state.replace(continuous=new_continuous, discrete=new_discrete, mask=new_mask)
