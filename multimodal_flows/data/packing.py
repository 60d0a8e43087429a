"""Block-diagonal multi-jet packing: shared layout utilities.

Several low-multiplicity jets share one `width`-token attention row behind
a same-segment mask (`ops/attention.py` `segments`), so the attention core
runs on full W=128 rows instead of padding every jet to
max_num_particles like the reference (`utils/tensorclass.py`,
`networks/attention.py:68-69`).  Round 3 applied this to sampling
(`sampling/generator.py`); this module hosts the layout math shared by the
sampler and the packed *training* path (round 4):

- `pack_jets`            — best-fit-decreasing bin packing of multiplicities
- `build_packed_rows`    — masks (R,W,1) + segment ids (R,W) for the layout
- `unpack_rows`          — scatter packed tokens back to the padded layout
- `pack_multimodal`      — scatter a padded MultiModal INTO packed rows,
                           with per-(row, jet-slot) bookkeeping for the
                           per-jet loss normalization (PackedJets)

Training needs what sampling did not: per-jet time (each jet draws its own
t ~ U[eps,1-eps], so packed rows carry per-token time scattered from the
jet slots) and per-jet loss normalization (masked MSE/CE are normalized by
each jet's particle count, reference `MMF.py:156-165`) — hence the
`segments`/`jet_valid` bookkeeping in `PackedJets`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import numpy as np
from multimodal_flows import pytree

from multimodal_flows.data.state import MultiModal


def pack_jets(mult: np.ndarray, width: int = 128):
    """Best-fit-decreasing bin packing of jet multiplicities into rows of
    `width` token slots.

    Returns (row_of (N,), offset_of (N,), n_rows): jet i occupies slots
    [offset_of[i], offset_of[i] + mult[i]) of row row_of[i].  Jets with
    mult > width get row_of = -1 (unpackable; caller routes them through
    an unpacked path).

    2-4 low-multiplicity jets share one 128-token attention row behind a
    block-diagonal segment mask instead of each paying its own small-T row
    (the width was chosen on an earlier accelerator and is unmeasured on
    H100).
    """
    mult = np.asarray(mult, np.int64)
    N = mult.shape[0]
    row_of = np.full(N, -1, np.int64)
    offset_of = np.zeros(N, np.int64)
    order = np.argsort(-mult, kind="stable")
    # bins indexed by remaining capacity: bins_by_cap[c] = [row ids]
    bins_by_cap = [[] for _ in range(width + 1)]
    fill = []  # current fill level per row
    for j in order:
        m = int(mult[j])
        if m > width or m == 0:
            continue
        for c in range(m, width + 1):
            if bins_by_cap[c]:
                b = bins_by_cap[c].pop()
                break
        else:
            b = len(fill)
            fill.append(0)
            c = width
        row_of[j] = b
        offset_of[j] = fill[b]
        fill[b] += m
        bins_by_cap[c - m].append(b)
    return row_of, offset_of, len(fill)


def build_packed_rows(pad_masks: np.ndarray, row_of, offset_of, n_rows: int,
                      width: int):
    """Masks (R, W, 1) and segment ids (R, W) for the packed layout.
    Pad slots carry segment -1."""
    mult = pad_masks[..., 0].sum(axis=1).astype(np.int64)
    packed = np.where(row_of >= 0)[0]
    seg = np.full((n_rows, width), -1, np.int32)
    # per-row segment counter: order jets by (row, offset)
    order = packed[np.lexsort((offset_of[packed], row_of[packed]))]
    prev_row = -1
    seg_id = 0
    for j in order:
        r, o, m = int(row_of[j]), int(offset_of[j]), int(mult[j])
        seg_id = seg_id + 1 if r == prev_row else 0
        prev_row = r
        seg[r, o:o + m] = seg_id
    mask = (seg >= 0).astype(np.int64)[..., None]
    return mask, seg


def unpack_rows(rows: MultiModal, pad_masks: np.ndarray, row_of, offset_of,
                width: int) -> MultiModal:
    """Scatter packed-row tokens back into the (N, D) padded layout."""
    N, D = pad_masks.shape[0], pad_masks.shape[1]
    mult = pad_masks[..., 0].sum(axis=1).astype(np.int64)
    packed = np.where(row_of >= 0)[0]
    m = mult[packed]
    total = int(m.sum())
    jet_of_tok = np.repeat(np.arange(len(packed)), m)
    within = np.arange(total) - np.repeat(np.cumsum(m) - m, m)
    src = (row_of[packed] * width + offset_of[packed])[jet_of_tok] + within
    dst_row = packed[jet_of_tok]

    def scatter(flat_rows, fill_dtype):
        out = np.zeros((N, D) + flat_rows.shape[2:], fill_dtype)
        flat = flat_rows.reshape(-1, *flat_rows.shape[2:])
        out[dst_row, within] = flat[src]
        return out

    x = None
    if rows.continuous is not None:
        x = scatter(np.asarray(rows.continuous), np.float32)
    k = None
    if rows.discrete is not None:
        k = scatter(np.asarray(rows.discrete), np.int32)
    return MultiModal(continuous=x, discrete=k,
                      mask=pad_masks.astype(np.int32))


class PackedJets(pytree.PyTreeNode):
    """A packed training batch/dataset: jets sharing `W`-token rows.

    continuous (R, W, Fc) fp32 | None, discrete (R, W, 1) int32 | None,
    mask (R, W, 1) int32, segments (R, W) int32 (pad slots -1, jets
    numbered 0..J-1 within their row), jet_valid (R, J) int32 — 1 where a
    jet occupies slot j of the row.  J is the max jets-per-row over the
    dataset (static; per-jet loss vectors are (R*J,) with `jet_valid`
    zeroing the empty slots).
    """

    continuous: Optional[jax.Array] = None
    discrete: Optional[jax.Array] = None
    mask: Optional[jax.Array] = None
    segments: Optional[jax.Array] = None
    jet_valid: Optional[jax.Array] = None

    def __len__(self) -> int:
        return self.mask.shape[0]

    @property
    def width(self) -> int:
        return self.mask.shape[1]

    @property
    def max_jets_per_row(self) -> int:
        return self.jet_valid.shape[1]

    @property
    def num_jets(self) -> int:
        return int(np.asarray(self.jet_valid).sum())

    def __getitem__(self, idx) -> "PackedJets":
        return jax.tree.map(lambda a: a[idx], self)


def pack_multimodal(jets: MultiModal, width: int = 128
                    ) -> Tuple[Optional[PackedJets], np.ndarray]:
    """Pack a padded MultiModal dataset into `width`-token rows.

    Returns (packed, leftover_idx): `packed` covers every jet whose
    multiplicity fits `width` (None when no jet fits); `leftover_idx`
    indexes jets with mult > width, which the caller trains as singleton
    rows at their native width (same packed loss, J=1).

    Requires first-n-filled masks (real particles before pads), like the
    bucketed/bucket-truncated paths.
    """
    pad_masks = np.asarray(jets.mask)
    N, D = pad_masks.shape[0], pad_masks.shape[1]
    mult = pad_masks[..., 0].sum(axis=1).astype(np.int64)
    first_n = (pad_masks[..., 0].cumsum(axis=1) ==
               np.minimum(np.arange(1, D + 1)[None, :], mult[:, None])).all()
    if not first_n:
        raise ValueError("pack_multimodal requires first-n-filled masks")

    row_of, offset_of, n_rows = pack_jets(mult, width)
    leftover = np.where((row_of < 0) & (mult > 0))[0]
    if n_rows == 0:
        return None, leftover

    row_mask, seg = build_packed_rows(pad_masks, row_of, offset_of, n_rows, width)

    # scatter jet payloads into the rows (vectorized: one index build)
    packed_j = np.where(row_of >= 0)[0]
    m = mult[packed_j]
    jet_of_tok = np.repeat(np.arange(len(packed_j)), m)
    within = np.arange(int(m.sum())) - np.repeat(np.cumsum(m) - m, m)
    dst_row = row_of[packed_j][jet_of_tok]
    dst_col = offset_of[packed_j][jet_of_tok] + within
    src_row = packed_j[jet_of_tok]

    x = None
    if jets.continuous is not None:
        xs = np.asarray(jets.continuous)
        x = np.zeros((n_rows, width) + xs.shape[2:], np.float32)
        x[dst_row, dst_col] = xs[src_row, within]
    k = None
    if jets.discrete is not None:
        ks = np.asarray(jets.discrete)
        k = np.zeros((n_rows, width) + ks.shape[2:], np.int32)
        k[dst_row, dst_col] = ks[src_row, within]

    # per-(row, slot) jet presence: segment ids are 0..J-1 within each row
    jets_per_row = np.zeros(n_rows, np.int64)
    np.add.at(jets_per_row, row_of[packed_j], 1)
    J = int(jets_per_row.max())
    jet_valid = (np.arange(J)[None, :] < jets_per_row[:, None]).astype(np.int32)

    packed = PackedJets(continuous=x, discrete=k,
                        mask=row_mask.astype(np.int32),
                        segments=seg.astype(np.int32),
                        jet_valid=jet_valid)
    return packed, leftover


@dataclasses.dataclass
class PackedDataset:
    """In-memory packed-rows dataset with the `ArrayDataset` protocol
    (`len`, slice-indexing, a `.coupling` pytree) so the trainer's epoch
    machinery (shuffle/stack/ship/resident-gather) runs on it unchanged."""

    coupling: PackedJets

    def __len__(self) -> int:
        return len(self.coupling)

    def __getitem__(self, idx) -> PackedJets:
        return self.coupling[idx]


def pad_rows(packed: PackedJets, multiple: int) -> PackedJets:
    """Pad the row count up to a multiple of `multiple` with EMPTY rows
    (mask 0, segments -1, jet_valid 0): every epoch batch compiles at the
    same shape and no row is ever dropped by `drop_last`.  Empty rows
    contribute nothing to any loss (per-jet weights are 0; global masked
    normalizations count only real tokens)."""
    R = len(packed)
    pad = (-R) % multiple
    if pad == 0:
        return packed

    def padz(a, fill=0):
        extra = np.full((pad,) + a.shape[1:], fill, a.dtype)
        return np.concatenate([np.asarray(a), extra], axis=0)

    return PackedJets(
        continuous=None if packed.continuous is None else padz(packed.continuous),
        discrete=None if packed.discrete is None else padz(packed.discrete),
        mask=padz(packed.mask),
        segments=padz(packed.segments, fill=-1),
        jet_valid=padz(packed.jet_valid),
    )


def singleton_rows(jets: MultiModal) -> PackedJets:
    """Wrap padded jets as one-jet-per-row PackedJets (J=1): the packed
    loss path at the jets' native width, for jets too wide to pack."""
    mask = np.asarray(jets.mask).astype(np.int32)
    seg = np.where(mask[..., 0] > 0, 0, -1).astype(np.int32)
    x = None if jets.continuous is None else np.asarray(jets.continuous, np.float32)
    k = None if jets.discrete is None else np.asarray(jets.discrete).astype(np.int32)
    jet_valid = np.ones((mask.shape[0], 1), np.int32)
    return PackedJets(continuous=x, discrete=k, mask=mask, segments=seg,
                      jet_valid=jet_valid)
