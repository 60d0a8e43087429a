"""Standalone CMS NanoAOD event-level feature extractor.

Re-design of the reference script (`scripts/extract_cms_nanoaod.py:27-134`):
reads NanoAOD ROOT files with uproot and writes event-level features
(object multiplicities, MET, leading-object kinematics, HT) to CSV/NPZ.

uproot is an optional dependency (not part of the JAX compute stack); the
script degrades with a clear error when it is missing.  All array work is
vectorized numpy/awkward-free where possible.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

BRANCHES = {
    "nJet": "nJet",
    "nMuon": "nMuon",
    "nElectron": "nElectron",
    "nPhoton": "nPhoton",
    "nFatJet": "nFatJet",
    "MET_pt": "MET_pt",
    "MET_phi": "MET_phi",
}

LEADING = {
    "Jet_pt": "leading_jet_pt",
    "Jet_eta": "leading_jet_eta",
    "Jet_phi": "leading_jet_phi",
    "Muon_pt": "leading_muon_pt",
    "Electron_pt": "leading_electron_pt",
}


def extract_event_level(path: str, tree: str = "Events", max_events: int | None = None):
    """Extract per-event scalar features from one NanoAOD file."""
    try:
        import uproot
    except ImportError as e:
        raise RuntimeError(
            "uproot is required for NanoAOD extraction (pip install uproot); "
            "it is not part of the JAX runtime environment") from e

    out = {}
    with uproot.open(path) as f:
        events = f[tree]
        stop = max_events

        for branch, name in BRANCHES.items():
            if branch in events:
                out[name] = np.asarray(events[branch].array(entry_stop=stop))

        for branch, name in LEADING.items():
            if branch in events:
                arr = events[branch].array(entry_stop=stop)
                # leading = first entry per event; 0 when the event has none
                firsts = np.asarray(
                    [float(a[0]) if len(a) else 0.0 for a in arr], dtype=np.float32)
                out[name] = firsts

        if "Jet_pt" in events:
            jet_pt = events["Jet_pt"].array(entry_stop=stop)
            out["HT"] = np.asarray([float(sum(a)) for a in jet_pt], dtype=np.float32)

    n = len(next(iter(out.values())))
    assert all(len(v) == n for v in out.values())
    return out


def write_outputs(features: dict, out_prefix: str, fmt: str = "both") -> None:
    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)) or ".", exist_ok=True)
    if fmt in ("npz", "both"):
        np.savez_compressed(out_prefix + ".npz", **features)
    if fmt in ("csv", "both"):
        keys = list(features)
        rows = np.stack([np.asarray(features[k], dtype=np.float64) for k in keys], axis=1)
        header = ",".join(keys)
        np.savetxt(out_prefix + ".csv", rows, delimiter=",", header=header, comments="")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", "-i", type=str, nargs="+", required=True,
                   help="NanoAOD .root file(s)")
    p.add_argument("--output", "-o", type=str, default="event_features")
    p.add_argument("--tree", type=str, default="Events")
    p.add_argument("--max_events", "-n", type=int, default=None)
    p.add_argument("--format", type=str, default="both", choices=["csv", "npz", "both"])
    args = p.parse_args(argv)

    all_feats: dict[str, list] = {}
    for path in args.input:
        feats = extract_event_level(path, tree=args.tree, max_events=args.max_events)
        for k, v in feats.items():
            all_feats.setdefault(k, []).append(v)

    merged = {k: np.concatenate(v) for k, v in all_feats.items()}
    write_outputs(merged, args.output, fmt=args.format)
    print(f"wrote {len(next(iter(merged.values())))} events -> {args.output}.[csv|npz]")


if __name__ == "__main__":
    main()
