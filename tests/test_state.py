"""Unit tests for the MultiModal / DataCoupling pytrees."""

import jax
import jax.numpy as jnp
import numpy as np

from multimodal_flows.data.state import DataCoupling, MultiModal
from tests.conftest import make_jets


def test_len_shape_modes(jets):
    assert len(jets) == 4
    assert jets.shape == (4, 10)
    assert jets.available_modes() == ["continuous", "discrete"]
    assert jets.has_continuous and jets.has_discrete
    assert jets.num_particles == 10


def test_is_pytree(jets):
    leaves = jax.tree.leaves(jets)
    assert len(leaves) == 3  # continuous, discrete, mask (time is None)

    @jax.jit
    def f(s: MultiModal):
        return s.replace(continuous=s.continuous * 2)

    out = f(jets.to_device())
    np.testing.assert_allclose(np.asarray(out.continuous), np.asarray(jets.continuous) * 2)


def test_getitem_and_concat(jets):
    sub = jets[:2]
    assert len(sub) == 2
    both = MultiModal.concat([jets[:2], jets[2:]])
    np.testing.assert_array_equal(np.asarray(both.mask), np.asarray(jets.mask))
    stacked = MultiModal.stack([jets, jets])
    assert stacked.continuous.shape == (2, 4, 10, 3)


def test_apply_mask():
    jets = make_jets(seed=3)
    dirty = jets.replace(
        continuous=np.asarray(jets.continuous) + 1.0,  # pollute pads
        discrete=np.asarray(jets.discrete) + 1,
    )
    clean = dirty.to_device().apply_mask()
    m = np.asarray(jets.mask)
    assert np.all(np.asarray(clean.continuous)[m[..., 0] == 0] == 0)
    assert np.all(np.asarray(clean.discrete)[m == 0] == 0)
    assert clean.discrete.dtype == jnp.int32


def test_hdf5_roundtrip(tmp_path, jets):
    path = str(tmp_path / "state.h5")
    jets.save_to(path)
    loaded = MultiModal.load_from(path)
    np.testing.assert_allclose(np.asarray(loaded.continuous), np.asarray(jets.continuous))
    np.testing.assert_array_equal(np.asarray(loaded.discrete), np.asarray(jets.discrete))
    np.testing.assert_array_equal(np.asarray(loaded.mask), np.asarray(jets.mask))
    assert loaded.time is None

    # transform hook
    loaded2 = MultiModal.load_from(path, transform={"continuous": lambda x: x * 0})
    assert np.all(np.asarray(loaded2.continuous) == 0)


def test_coupling(coupling):
    assert len(coupling) == 4
    assert coupling.has_source and coupling.has_target and not coupling.has_context
    sub = coupling[1:3]
    assert len(sub) == 2
    assert not coupling.source.has_continuous  # source only has a mask
