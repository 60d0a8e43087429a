"""Golden tests for the AOJ featurization pipeline on a synthetic .h5 file
(reference parity: `utils/aoj.py:24-320`, `:875-889`)."""

import h5py
import numpy as np
import pytest

from multimodal_flows.data.aoj import (
    AspenOpenJets,
    extract_metadata,
    filter_particles,
    map_pid_to_tokens,
    multiplicity_histogram,
    pt_sort,
    sample_from_empirical_masks,
    wrap_phi,
)


def write_synthetic_aoj(path, num_jets=20, max_p=12, seed=0):
    """PFCands layout: px,py,pz,e,d0,d0Err,dz,dzErr,pid,charge."""
    rng = np.random.default_rng(seed)
    pf = np.zeros((num_jets, max_p, 10), dtype=np.float32)
    pids = np.array([22, 130, -211, 211, -11, 11, -13, 13])
    for j in range(num_jets):
        n = rng.integers(3, max_p + 1)
        pt = rng.uniform(1, 100, n)
        # collimated jet: particles within a cone around a random axis
        axis_phi = rng.uniform(-np.pi, np.pi)
        axis_eta = rng.uniform(-1.0, 1.0)
        phi = axis_phi + rng.uniform(-0.4, 0.4, n)
        eta = axis_eta + rng.uniform(-0.4, 0.4, n)
        px, py = pt * np.cos(phi), pt * np.sin(phi)
        pz = pt * np.sinh(eta)
        e = np.sqrt(px**2 + py**2 + pz**2)
        pf[j, :n, 0], pf[j, :n, 1], pf[j, :n, 2], pf[j, :n, 3] = px, py, pz, e
        pf[j, :n, 4:8] = rng.normal(size=(n, 4)) * 0.01
        pf[j, :n, 8] = rng.choice(pids, n)
        # one bad-pid particle in jet 0
        if j == 0:
            pf[j, 0, 8] = 2
    with h5py.File(path, "w") as f:
        f.create_dataset("PFCands", data=pf)
    return pf


@pytest.fixture
def aoj_file(tmp_path):
    path = tmp_path / "RunG_test.h5"
    pf = write_synthetic_aoj(str(path))
    return str(tmp_path), "RunG_test.h5", pf


def test_map_pid_to_tokens():
    pid = np.array([[22, 130, -211, 211, -11, 11, -13, 13, 2, 0]])
    tok = map_pid_to_tokens(pid)
    np.testing.assert_array_equal(tok[0], [1, 2, 3, 4, 5, 6, 7, 8, 0, 0])


def test_filter_particles_zeroes_bad_pids():
    pf = np.ones((1, 3, 10))
    pf[0, 1, -2] = 2      # bad pid -> zeroed
    pf[0, 0, -2] = 211
    pf[0, 2, -2] = 22
    out = filter_particles(pf)
    assert np.all(out[0, 1] == 0)
    assert np.all(out[0, 0] != 0)


def test_pt_sort_descending():
    pf = np.zeros((1, 3, 10))
    pf[0, :, 0] = [1.0, 5.0, 3.0]  # px (py=0 -> pt=px)
    out = pt_sort(pf)
    np.testing.assert_allclose(out[0, :, 0], [5.0, 3.0, 1.0])


def test_wrap_phi():
    assert abs(wrap_phi(np.array(3 * np.pi / 2)) - (-np.pi / 2)) < 1e-9
    assert abs(wrap_phi(np.array(-3 * np.pi / 2)) - (np.pi / 2)) < 1e-9


def test_loader_end_to_end(aoj_file):
    data_dir, fname, pf = aoj_file
    aoj = AspenOpenJets(data_dir, fname)
    jets, metadata = aoj(max_num_particles=10, transform="standardize")

    B, D = jets.continuous.shape[:2]
    assert D == 10
    assert jets.discrete.shape == (B, D, 1)
    assert jets.mask.shape == (B, D, 1)

    m = jets.mask[..., 0] > 0
    # pads fully zeroed
    assert np.all(jets.continuous[~m] == 0)
    assert np.all(jets.discrete[..., 0][~m] == 0)
    # real tokens in 1..8
    toks = jets.discrete[..., 0][m]
    assert toks.min() >= 1 and toks.max() <= 8
    # standardized real features ~ N(0,1)
    x = jets.continuous[m]
    np.testing.assert_allclose(x.mean(0), 0.0, atol=1e-4)
    np.testing.assert_allclose(x.std(0, ddof=1), 1.0, atol=1e-3)
    # metadata round-trip fields
    assert set(metadata) >= {"mean", "std", "min", "max", "num_jets_sample"}
    # pT ordering within jets (destandardized); diff only over adjacent
    # real pairs — an -inf pad sentinel would emit inf-inf NaN warnings
    pt = jets.continuous[..., 0] * metadata["std"][0] + metadata["mean"][0]
    d = np.diff(np.where(m, pt, 0.0), axis=1)
    both_real = m[:, 1:] & m[:, :-1]
    assert np.all(d[both_real] <= 1e-4)


def test_loader_names_missing_h5py(aoj_file, monkeypatch):
    """Without h5py installed, reading an AOJ file says which package is
    missing instead of failing deep in the loader."""
    import sys

    data_dir, fname, _ = aoj_file
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py package"):
        AspenOpenJets(data_dir, fname)(max_num_particles=10)


def test_loader_relative_coordinates(aoj_file):
    """eta_rel/phi_rel are relative to the summed-jet axis."""
    data_dir, fname, pf = aoj_file
    aoj = AspenOpenJets(data_dir, fname)
    jets, _ = aoj(max_num_particles=12, transform=None)
    # pT-weighted centroid of phi_rel should be near 0
    pt = jets.continuous[..., 0]
    phi_rel = jets.continuous[..., 2]
    centroid = (pt * phi_rel).sum(1) / pt.sum(1)
    assert np.abs(centroid).mean() < 0.2


def test_loader_num_jets_cap(aoj_file):
    data_dir, fname, _ = aoj_file
    jets, _ = AspenOpenJets(data_dir, fname)(num_jets=5, max_num_particles=8)
    assert len(jets) == 5


def test_loader_onehot(aoj_file):
    data_dir, fname, _ = aoj_file
    jets, _ = AspenOpenJets(data_dir, fname)(
        max_num_particles=8,
        features={"continuous": ["pt"], "discrete": "onehot"})
    assert jets.continuous.shape[-1] == 1 + 8  # pt + 8 onehot cols
    assert jets.discrete is None


def test_loader_ghost_padding(aoj_file):
    data_dir, fname, _ = aoj_file
    jets, _ = AspenOpenJets(data_dir, fname)(max_num_particles=12, padding="ghosts")
    # ghosts fill all slots -> full mask
    assert np.all(jets.mask == 1)
    assert np.all(jets.continuous[..., 0] > 0)  # all pt positive


def test_loader_shuffled_particles(aoj_file):
    data_dir, fname, _ = aoj_file
    jets, _ = AspenOpenJets(data_dir, fname)(max_num_particles=12, pt_order=False)
    pt = np.where(jets.mask[..., 0] > 0, jets.continuous[..., 0], np.nan)
    # at least one jet not sorted descending
    diffs = np.diff(pt, axis=1)
    assert np.nansum(diffs > 1e-6) > 0


def test_empirical_mask_sampler():
    rng = np.random.default_rng(0)
    n = rng.integers(5, 20, size=500)
    mask = (np.arange(30)[None, :] < n[:, None]).astype(np.int64)[:, :, None]
    out = sample_from_empirical_masks(mask, num_jets=1000, max_num_particles=30)
    assert out.shape == (1000, 30, 1)
    nums = out[..., 0].sum(1)
    assert nums.min() >= 5 and nums.max() < 20
    # first-n filling
    first = out[0, :, 0]
    k = first.sum()
    assert np.all(first[:k] == 1) and np.all(first[k:] == 0)


def test_multiplicity_histogram_density():
    mask = np.ones((10, 5, 1), np.int64)
    hist = multiplicity_histogram(mask, 5)
    assert hist.sum() == pytest.approx(1.0)
    assert hist[5] == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# real-schema golden tests (VERDICT r3 #7): full PFCands column set,
# PID zoo, and the pre-sorted-order assumption
# ---------------------------------------------------------------------------


def write_real_schema_aoj(path, num_jets=24, max_p=16, seed=0,
                          presorted=False, pid_zoo=False):
    """Synthetic file in the published AOJ schema: (J, P, 10) float32
    [px, py, pz, E, d0, d0Err, dz, dzErr, pid, charge], zero-padded,
    realistic impact parameters, optionally UNSORTED in pT and with the
    full CMS PF pid zoo (HF types 1/2 that must be filtered, plus an
    out-of-map |pid| >= 11)."""
    rng = np.random.default_rng(seed)
    pf = np.zeros((num_jets, max_p, 10), dtype=np.float32)
    pids = np.array([22, 130, -211, 211, -11, 11, -13, 13])
    charge = {22: 0, 130: 0, -211: -1, 211: 1, -11: -1, 11: 1, -13: -1, 13: 1}
    for j in range(num_jets):
        n = int(rng.integers(4, max_p + 1))
        pt = rng.exponential(30, n) + 1
        if presorted:
            pt = np.sort(pt)[::-1]
        axis_phi = rng.uniform(-np.pi, np.pi)
        axis_eta = rng.uniform(-1.5, 1.5)
        phi = axis_phi + rng.uniform(-0.4, 0.4, n)
        eta = axis_eta + rng.uniform(-0.4, 0.4, n)
        px, py = pt * np.cos(phi), pt * np.sin(phi)
        pz = pt * np.sinh(eta)
        e = np.sqrt(px**2 + py**2 + pz**2)
        pid = rng.choice(pids, n)
        if pid_zoo and n >= 3:
            pid[0] = 1      # CMS HF hadron: |pid| < 11, must be filtered
            pid[1] = 2      # CMS HF EM: same
            pid[2] = 3122   # out-of-map |pid| >= 11: token 0, kept
        pf[j, :n, 0], pf[j, :n, 1], pf[j, :n, 2], pf[j, :n, 3] = px, py, pz, e
        # track-like impact parameters with errors (charged only)
        ch = np.array([charge.get(int(p), 0) for p in pid], np.float32)
        pf[j, :n, 4] = rng.normal(0, 0.01, n) * (ch != 0)
        pf[j, :n, 5] = np.abs(rng.normal(0.002, 0.0005, n)) * (ch != 0)
        pf[j, :n, 6] = rng.normal(0, 0.05, n) * (ch != 0)
        pf[j, :n, 7] = np.abs(rng.normal(0.01, 0.002, n)) * (ch != 0)
        pf[j, :n, 8] = pid
        pf[j, :n, 9] = ch
    with h5py.File(path, "w") as f:
        f.create_dataset("PFCands", data=pf)
    return pf


def test_real_schema_impact_parameter_features(tmp_path):
    """d0/d0Err/dz/dzErr columns are selectable continuous features and
    round-trip from the file through pT sorting (reference consumes the
    same columns, `utils/aoj.py:266-288`)."""
    pf = write_real_schema_aoj(str(tmp_path / "RunG_real.h5"), presorted=True)
    aoj = AspenOpenJets(str(tmp_path), "RunG_real.h5")
    jets, _ = aoj(max_num_particles=16, transform=None,
                  features={"continuous": ["pt", "d0", "d0Err", "dz", "dzErr"],
                            "discrete": "tokens"})
    m = jets.mask[..., 0] > 0
    assert jets.continuous.shape[-1] == 5
    # per-jet: the file was written presorted, so featurized rows align
    # with file rows and the d0 column must match exactly
    np.testing.assert_allclose(jets.continuous[..., 1], pf[..., 4], atol=1e-7)
    np.testing.assert_allclose(jets.continuous[..., 3], pf[..., 6], atol=1e-7)
    # error columns are non-negative and zero exactly for neutrals + pads
    neutral_or_pad = (pf[..., 9] == 0)
    assert np.all(jets.continuous[..., 2][neutral_or_pad] == 0)
    assert np.all(jets.continuous[..., 2] >= 0)


def test_real_schema_pid_zoo(tmp_path):
    """CMS HF candidate types (|pid| < 11) are filtered out of the mask;
    out-of-map |pid| >= 11 keeps kinematics with token 0 (matches
    reference `utils/aoj.py:193-222`)."""
    pf = write_real_schema_aoj(str(tmp_path / "RunG_zoo.h5"), pid_zoo=True)
    aoj = AspenOpenJets(str(tmp_path), "RunG_zoo.h5")
    jets, _ = aoj(max_num_particles=16, transform=None)

    n_file = (pf[..., 3] > 0).sum()
    n_hf = np.isin(pf[..., 8], [1, 2]).sum()
    m = jets.mask[..., 0] > 0
    # HF candidates dropped from the mask, everything else kept
    assert m.sum() == n_file - n_hf
    # the out-of-map Lambda stays, as token 0 with real kinematics
    toks = jets.discrete[..., 0]
    n_lambda = (pf[..., 8] == 3122).sum()
    assert ((toks == 0) & m).sum() == n_lambda
    assert np.all(jets.continuous[..., 0][(toks == 0) & m] > 0)


def test_real_schema_unsorted_file_token_alignment(tmp_path):
    """Tokens stay aligned with kinematics for an UNSORTED input file.

    The reference derives tokens from the unsorted PFCands while the
    kinematics are pT-sorted (`utils/aoj.py:171-172`) — a latent
    misalignment that is a no-op only because published AOJ files ship
    pre-sorted.  This loader sorts once and featurizes everything from
    the same tensor (`data/aoj.py:130-135`), so an unsorted file and its
    pre-sorted copy must produce identical jets."""
    pf = write_real_schema_aoj(str(tmp_path / "RunG_unsorted.h5"),
                               presorted=False, seed=11)
    # pre-sorted copy of the same events
    pt = np.sqrt(pf[..., 0] ** 2 + pf[..., 1] ** 2)
    order = np.argsort(-pt, axis=1, kind="stable")
    pf_sorted = np.take_along_axis(pf, order[:, :, None], axis=1)
    with h5py.File(str(tmp_path / "RunG_sorted.h5"), "w") as f:
        f.create_dataset("PFCands", data=pf_sorted)

    a, _ = AspenOpenJets(str(tmp_path), "RunG_unsorted.h5")(
        max_num_particles=16, transform=None)
    b, _ = AspenOpenJets(str(tmp_path), "RunG_sorted.h5")(
        max_num_particles=16, transform=None)
    np.testing.assert_allclose(a.continuous, b.continuous, atol=1e-6)
    np.testing.assert_array_equal(a.discrete, b.discrete)
    np.testing.assert_array_equal(a.mask, b.mask)
    # and per jet, the leading token really belongs to the leading-pT
    # particle of the raw file
    lead = np.argmax(pt * (pf[..., 3] > 0), axis=1)
    from multimodal_flows.data.aoj import map_pid_to_tokens
    expect = map_pid_to_tokens(pf[np.arange(len(pf)), lead, 8])
    np.testing.assert_array_equal(a.discrete[:, 0, 0], expect)
