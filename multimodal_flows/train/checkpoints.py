"""Checkpointing: best-k per monitored metric + last.

Replaces the reference's three Lightning `ModelCheckpoint`s
(`scripts/train_mmf.py:128-148`, monitors val_loss / val_loss_mse /
val_loss_ce, `save_last=True`) and the EMA piggyback
(`model/MMF.py:112-134`): here params, EMA params, optimizer state, and
step/epoch are one pytree saved atomically as a flat `.npz` of its leaves
(keyed by their tree paths) and restored into the caller's target tree,
with the target's shardings; a JSON index tracks the best value per
monitor so `best`, `best_mse`, `best_ce`, `last` are plain subdirectories
that `load()` can target by name.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional

import jax
import numpy as np

MONITORS = {
    "best": "val_loss",
    "best_mse": "val_loss_mse",
    "best_ce": "val_loss_ce",
    # in-training sampled-W1 monitor (train/physics_eval.py); the metric is
    # only present on physics-eval epochs — absent values are skipped, so
    # the slot stays empty unless config.physics_eval_every_n_epochs > 0
    "best_physics": "val_w1_physics",
}


class CheckpointManager:
    def __init__(self, ckpt_dir: str, monitors: Optional[Dict[str, str]] = None,
                 top_k: int = 10, physics_margin: float = 0.0):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.monitors = dict(monitors) if monitors is not None else dict(MONITORS)
        self.top_k = int(top_k)
        # Tie-to-later selection for the `best_physics` slot (margin > 0):
        # the slot holds the LATEST checkpoint whose score is within
        # (1 + margin) of the best score seen, instead of the argmin.
        # Round 5 measured why argmin cannot work at in-training eval
        # sizes: under common random numbers, checkpoints of equal true
        # quality still differ by ~15% per seed at 2k jets while
        # genuinely-worse ones separate by 60%+ (PHYSEVAL_CRN_r05.md), so
        # an argmin over ~30 evals selects a noise dip (winner's curse —
        # CLOSURE_r04/r05 run 1 both mis-ranked).  Under a cosine schedule
        # quality is monotone-ish, so among statistical ties the later
        # checkpoint is the right pick; a score beyond the margin
        # (divergence, late overfit) freezes the slot at the last healthy
        # epoch — the protection the reference's val-loss monitors
        # (`scripts/train_mmf.py:128-148`) were meant to give.
        self.physics_margin = float(physics_margin)
        self._index_path = os.path.join(self.dir, "index.json")
        self.index: Dict[str, Any] = {"best_values": {}, "history": []}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self.index = json.load(f)
        self.index.setdefault("topk", {})

    # ------------------------------------------------------------------ io
    #
    # Multi-host discipline: every process calls save()/load() (sharded
    # leaves are all-gathered, a collective, and process 0 writes the
    # file; every process reads it back into its own shards), and all
    # FILESYSTEM bookkeeping on the shared experiment dir — the tmp->final rename,
    # symlink repointing, eviction rmtrees, index.json — runs on process 0
    # only, fenced by barriers so no process can read a half-renamed slot.
    # (The reference leaned on Lightning's rank-zero-only ModelCheckpoint
    # for the same contract, `scripts/train_mmf.py:128-148`.)

    @staticmethod
    def _is_primary() -> bool:
        return jax.process_index() == 0

    @staticmethod
    def _barrier(tag: str) -> None:
        if jax.process_count() > 1:
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices(f"ckpt-{tag}")

    def _save_to(self, name: str, state) -> None:
        path = os.path.join(self.dir, name)
        tmp = path + ".tmp"
        if self._is_primary() and os.path.exists(tmp):
            shutil.rmtree(tmp)
        self._barrier(f"pre-save-{name}")
        arrays = _host_leaves(state)
        if self._is_primary():
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, _STATE_FILE), **arrays)
        self._barrier(f"post-save-{name}")
        if self._is_primary():
            if os.path.exists(path):
                shutil.rmtree(path)
            os.replace(tmp, path)
        self._barrier(f"post-rename-{name}")

    def _write_index(self) -> None:
        if not self._is_primary():
            return
        with open(self._index_path, "w") as f:
            json.dump(self.index, f, indent=1)

    # ---------------------------------------------------------------- save

    def save(self, state, metrics: Dict[str, float], epoch: int) -> Dict[str, bool]:
        """Save `last` and, per monitor, keep the `top_k` best checkpoints
        (reference `save_top_k=10` per ModelCheckpoint,
        `scripts/train_mmf.py:128-148`).

        The plain slot directory (`best` / `best_mse` / `best_ce`) always
        holds the #1 checkpoint; runners-up live in `{slot}-ep{epoch}`
        directories ranked in the JSON index, worst evicted beyond k.
        Returns which slots were written: `written[slot]` means a new #1,
        `written[slot + "_topk"]` means the value entered the top-k.
        """
        written = {"last": True}
        self._save_to("last", state)

        import math

        for slot, metric in self.monitors.items():
            value = metrics.get(metric)
            written[slot] = written[slot + "_topk"] = False
            if value is None:
                continue
            value = float(value)
            # a NaN/inf metric (diverged epoch) must never enter the
            # ranking: NaN comparisons are all False, so one poisoned
            # entry would scramble the sort and freeze the best slot
            # for the rest of the run
            if not math.isfinite(value):
                continue
            margin_mode = slot == "best_physics" and self.physics_margin > 0
            if margin_mode:
                rec = self.index["best_values"].get(slot) or {}
                best_val = min(value, rec.get("min_value", value))
                healthy = value <= best_val * (1 + self.physics_margin)
                if healthy:
                    # latest healthy checkpoint takes the slot (a real
                    # directory, independent of the top-k symlink space)
                    self._save_to(slot, state)
                    written[slot] = True
                self.index["best_values"][slot] = {
                    "min_value": best_val,
                    "value": value if healthy else rec.get("value"),
                    "epoch": epoch if healthy else rec.get("epoch"),
                    "frozen": not healthy,
                }
            ranked = self.index["topk"].setdefault(slot, [])
            # resume from a non-`last` slot re-runs epochs whose names are
            # already ranked: replace the stale entry instead of appending
            # a duplicate (two entries sharing one directory would make
            # eviction of one delete the other's storage)
            name = f"{slot}-ep{epoch}"
            ranked[:] = [e for e in ranked if e["name"] != name]
            in_topk = len(ranked) < self.top_k or value < ranked[-1]["value"]
            if not in_topk:
                continue
            entry = {"value": value, "epoch": epoch, "name": name}
            self._save_to(entry["name"], state)
            ranked.append(entry)
            ranked.sort(key=lambda e: e["value"])
            evicted = ranked[self.top_k:]
            del ranked[self.top_k:]
            written[slot + "_topk"] = True
            link = os.path.join(self.dir, slot)
            if margin_mode:
                # the plain slot dir is owned by the tie-to-later rule
                # above; the ranking here only tracks runners-up by value
                pass
            elif ranked[0]["name"] == entry["name"]:  # new overall best
                # the plain slot (`best`, `best_mse`, ...) is a symlink to
                # the #1 ranked dir — avoids a second full serialization of
                # the same pytree every improving epoch.  Re-pointed BEFORE
                # eviction rmtrees below, so a crash in between never
                # leaves the slot dangling at a deleted directory.
                if self._is_primary():
                    if os.path.islink(link):
                        os.unlink(link)
                    elif os.path.isdir(link):  # legacy full-copy slot
                        shutil.rmtree(link)
                    os.symlink(entry["name"], link)
                self.index["best_values"][slot] = {"value": value, "epoch": epoch}
                written[slot] = True
            # evict after the link is current; never delete the directory
            # the slot link still points at
            if self._is_primary():
                link_target = os.readlink(link) if os.path.islink(link) else None
                for ev in evicted:
                    if ev["name"] == link_target:
                        continue
                    path = os.path.join(self.dir, ev["name"])
                    if os.path.exists(path):
                        shutil.rmtree(path)

        self.index["history"].append(
            {"epoch": epoch, **{k: float(v) for k, v in metrics.items()}})
        self._write_index()
        self._barrier("post-index")
        return written

    # ---------------------------------------------------------------- load

    def load(self, target, name: str = "last"):
        """Restore a checkpoint by slot name onto an abstract `target`
        pytree (same structure/dtypes as a fresh train state)."""
        path = os.path.join(self.dir, name)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint slot {name!r} in {self.dir}")
        return _restore(target, path)

    def has(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.dir, name))

    @staticmethod
    def load_path(target, path: str):
        """Restore from an explicit checkpoint directory (the reference's
        `--ckpt_path` warm start, `scripts/train_mmf.py:24,170`)."""
        path = os.path.abspath(path)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint at {path}")
        return _restore(target, path)


_STATE_FILE = "state.npz"


def _host_leaves(tree) -> Dict[str, np.ndarray]:
    """{tree path: host array} for every leaf; arrays sharded across
    processes are all-gathered first (a collective: every process calls)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
            from jax.experimental import multihost_utils

            leaf = multihost_utils.process_allgather(leaf, tiled=True)
        out[jax.tree_util.keystr(path)] = np.asarray(leaf)
    return out


def _restore(target, path: str):
    """Load the leaves saved under `path` into the structure of `target`,
    with each leaf's dtype and, for device arrays, its sharding."""
    with np.load(os.path.join(path, _STATE_FILE)) as data:
        saved = {k: data[k] for k in data.files}

    def leaf(key_path, like):
        key = jax.tree_util.keystr(key_path)
        if key not in saved:
            raise KeyError(f"checkpoint {path} has no leaf {key}")
        arr = saved[key]
        if arr.shape != tuple(like.shape):
            raise ValueError(f"checkpoint leaf {key} has shape {arr.shape}, "
                             f"expected {tuple(like.shape)}")
        arr = arr.astype(like.dtype)
        sharding = getattr(like, "sharding", None)
        if sharding is None:
            return arr
        return jax.make_array_from_callback(arr.shape, sharding, lambda idx: arr[idx])

    return jax.tree_util.tree_map_with_path(leaf, target)
