"""Masked losses and multitask combination.

Re-designs of the reference loss math (`model/MMF.py:138-233`,
`model/CFM.py:108-130`, `model/MJB.py:101-124`):

- masked, per-jet-normalized MSE on the conditional drift
- masked cross-entropy on the posterior classifier; JAX has no
  `ignore_index`, so pad targets (token 0) are excluded by the same mask
  weighting (identical under zero-padding where target==0 iff mask==0)
- MultiTaskLoss with the reference's three modes: `sum`, `weighted`
  (learnable homoscedastic uncertainty), and `time-weighted` (an MLP over
  the sinusoidal time embedding emits per-sample uncertainties).  The
  uncertainty parameters live inside the trained module so they ride
  the same optimizer/checkpoint path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from multimodal_flows import nn

from multimodal_flows.models.blocks import DENSE_INIT, timestep_embedding

Array = jax.Array


def masked_mse(pred: Array, target: Array, mask: Array) -> Array:
    """Per-jet masked MSE (reference `MMF.py:156-159`).

    pred/target: (B, D, F); mask: (B, D, 1).  Sum over particles and
    features, normalized by the particle count (not count * F, matching the
    reference).  Returns (B,).
    """
    se = (pred - target) ** 2 * mask
    per_jet = se.sum(axis=(1, 2))
    denom = jnp.clip(mask.sum(axis=(1, 2)), 1.0, None)
    return per_jet / denom


def masked_ce(logits: Array, targets: Array, mask: Array) -> Array:
    """Per-jet masked cross entropy with pad targets excluded
    (reference `MMF.py:162-165`; `ignore_index=0` emulated by masking).

    logits: (B, D, V); targets: (B, D) or (B, D, 1) int; mask: (B, D, 1).
    Returns (B,).
    """
    if targets.ndim == 3:
        targets = targets[..., 0]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None].astype(jnp.int32), axis=-1)[..., 0]
    w = mask[..., 0].astype(jnp.float32) * (targets != 0)
    per_jet = (nll * w).sum(axis=1)
    denom = jnp.clip(mask[..., 0].astype(jnp.float32).sum(axis=1), 1.0, None)
    return per_jet / denom


# ---------------------------------------------------------------------------
# packed (multi-jet row) per-jet losses
# ---------------------------------------------------------------------------


def _per_jet_sums(values: Array, segments: Array, num_slots: int) -> Array:
    """Sum per-token `values` (B, W) into per-(row, jet-slot) sums (B, J).

    `segments` (B, W) holds within-row jet ids 0..J-1 (pad slots -1; their
    values are routed to an overflow slot and dropped).  One flattened
    `segment_sum` — XLA lowers it to a single scatter-add pass.
    """
    B, W = segments.shape
    slot = jnp.where(segments >= 0, segments, num_slots)         # pads -> overflow
    gid = (jnp.arange(B, dtype=jnp.int32)[:, None] * (num_slots + 1) + slot)
    sums = jax.ops.segment_sum(values.reshape(-1), gid.reshape(-1),
                               num_segments=B * (num_slots + 1))
    return sums.reshape(B, num_slots + 1)[:, :num_slots]


def packed_masked_mse(pred: Array, target: Array, mask: Array,
                      segments: Array, num_slots: int) -> Array:
    """Per-jet masked MSE over packed rows (the packed twin of
    `masked_mse`): pred/target (B, W, F), mask (B, W, 1), segments (B, W).
    Returns (B, J) — per-jet sum of squared errors normalized by the jet's
    particle count (reference `MMF.py:156-159` normalization)."""
    se = ((pred - target) ** 2 * mask).sum(axis=-1)              # (B, W)
    per_jet = _per_jet_sums(se.astype(jnp.float32), segments, num_slots)
    counts = _per_jet_sums(mask[..., 0].astype(jnp.float32), segments, num_slots)
    return per_jet / jnp.clip(counts, 1.0, None)


def packed_masked_ce(logits: Array, targets: Array, mask: Array,
                     segments: Array, num_slots: int) -> Array:
    """Per-jet masked cross entropy over packed rows (packed twin of
    `masked_ce`): logits (B, W, V), targets (B, W) or (B, W, 1), mask
    (B, W, 1).  Returns (B, J)."""
    if targets.ndim == 3:
        targets = targets[..., 0]
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    nll = -jnp.take_along_axis(logp, targets[..., None].astype(jnp.int32), axis=-1)[..., 0]
    w = mask[..., 0].astype(jnp.float32) * (targets != 0)
    per_jet = _per_jet_sums(nll * w, segments, num_slots)
    counts = _per_jet_sums(mask[..., 0].astype(jnp.float32), segments, num_slots)
    return per_jet / jnp.clip(counts, 1.0, None)


def _wmean(x: Array, weights: Optional[Array]) -> Array:
    if weights is None:
        return x.mean()
    w = weights.astype(jnp.float32)
    return (x * w).sum() / jnp.clip(w.sum(), 1.0, None)


class MultiTaskLoss(nn.Module):
    """Combine the MSE and CE tasks (reference `MMF.py:203-233`).

    Returns (loss, loss_1_mean, loss_2_mean, w1, w2) — w's are None-like
    zeros for 'sum' mode.  Optional `weights` (same leading shape as the
    per-jet losses) exclude entries from every mean — packed multi-jet
    rows pass jet-slot validity here so empty slots don't dilute the loss.
    """

    mode: str
    n_embd: int

    def __call__(self, loss_1: Array, loss_2: Array, time: Optional[Array] = None,
                 weights: Optional[Array] = None
                 ) -> Tuple[Array, Array, Array, Array, Array]:
        if self.mode == "sum":
            loss = loss_1 + loss_2
            zero = jnp.zeros(())
            return (_wmean(loss, weights), _wmean(loss_1, weights),
                    _wmean(loss_2, weights), zero, zero)

        if self.mode == "weighted":
            u = self.param("loss_weights", nn.initializers.zeros, (2,))
            u1, u2 = u[0], u[1]
            w1, w2 = jnp.exp(-u1), jnp.exp(-u2)
            loss = 0.5 * (u1 + w1 * loss_1) + 0.5 * (u2 + w2 * loss_2)
            return (_wmean(loss, weights), _wmean(loss_1, weights),
                    _wmean(loss_2, weights), w1, w2)

        if self.mode == "time-weighted":
            assert time is not None
            t_emb = timestep_embedding(time, self.n_embd)              # (B, E)
            h = nn.Dense(self.n_embd, kernel_init=DENSE_INIT, name="c_fc")(t_emb)
            h = nn.gelu(h, approximate=False)
            # zero-init output bias -> start balanced L = Lmse + Lce
            # (reference `MMF.py:214`)
            uu = nn.Dense(2, kernel_init=DENSE_INIT, bias_init=nn.initializers.zeros,
                          name="c_proj")(h)                            # (B, 2)
            u1, u2 = uu[..., 0], uu[..., 1]
            w1, w2 = jnp.exp(-u1), jnp.exp(-u2)
            loss = 0.5 * (u1 + w1 * loss_1) + 0.5 * (u2 + w2 * loss_2)
            return (_wmean(loss, weights), _wmean(loss_1, weights),
                    _wmean(loss_2, weights), _wmean(w1, weights), _wmean(w2, weights))

        raise ValueError(f"unknown multitask_loss mode {self.mode!r}")
