"""CPU rehearsal of `chip_smoke.py`: its device guard, and each phase as a
function at a tiny width (the script itself runs only on a GPU)."""

import jax
import numpy as np
import pytest

import chip_smoke
from multimodal_flows.train.systems import MMF


def _tiny_config(**kw):
    return chip_smoke.flagship_config(
        n_embd=16, n_inner=32, n_layer=1, n_layer_fused=1, n_head=2,
        max_num_particles=24, batch_size=16, pack_width=16, **kw)


def _tiny_jets(n, seed=0, num_wide=0):
    return chip_smoke.synthetic_jets(n, 24, seed, mean_mult=6, num_wide=num_wide,
                                     wide_above=16)


def test_device_guard_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.device_guard()


def test_synthetic_jets_layout():
    jets = _tiny_jets(40, num_wide=5)
    mult = jets.mask[..., 0].sum(1)
    assert (mult[:5] > 16).all() and (mult >= 3).all() and (mult <= 24).all()
    real = jets.mask[..., 0] > 0
    tokens = jets.discrete[..., 0]
    assert ((tokens[real] >= 1) & (tokens[real] <= 8)).all()
    assert (tokens[~real] == 0).all() and (jets.continuous[~real] == 0).all()
    # first-n filled masks (the packed and bucketed paths require them)
    assert (np.cumsum(jets.mask[..., 0], 1)[np.arange(40), mult - 1] == mult).all()


def test_train_phase_rehearsal(tmp_path, capsys):
    system, params = chip_smoke.train_phase(
        _tiny_config(lr=3e-3), _tiny_jets(320, num_wide=4), str(tmp_path), epochs=3,
        timed_epochs=2)
    out = capsys.readouterr().out
    assert "bit-identical" in out and "resume: epoch 3" in out
    assert isinstance(system, MMF) and params is not None


def test_sample_phase_rehearsal(capsys):
    cfg = _tiny_config()
    system = MMF(cfg)
    params = system.init_params(jax.random.PRNGKey(0))
    masks = np.asarray(_tiny_jets(40, seed=1, num_wide=3).mask)
    chip_smoke.sample_phase(system, params, masks, num_timesteps=4,
                            pack_width=16, batch_size=8)
    assert "3 bucketed" in capsys.readouterr().out


def test_precision_phase_rehearsal(capsys):
    system = MMF(_tiny_config())
    params = system.init_params(jax.random.PRNGKey(0))
    chip_smoke.precision_phase(system, params, np.asarray(_tiny_jets(8, seed=2).mask))
    assert "precision drift" in capsys.readouterr().out


def test_multichip_phase_rehearsal(capsys):
    chip_smoke.multichip_phase(_tiny_config(), _tiny_jets(64, seed=3), n_devices=4,
                               steps=2, num_timesteps=3)
    out = capsys.readouterr().out
    for name in ("data-parallel", "fsdp", "tensor_parallel=2", "sampler"):
        assert f"multichip {name}" in out


def test_check_sample_rejects_token_on_pad():
    jets = _tiny_jets(4)
    assert chip_smoke.check_sample(jets, np.asarray(jets.mask), 9) == 0.0
    bad = jets.replace(discrete=jets.discrete + (1 - jets.mask))
    with pytest.raises(RuntimeError, match="padded slot"):
        chip_smoke.check_sample(bad, np.asarray(jets.mask), 9)
    bad = jets.replace(discrete=jets.discrete * 9)
    with pytest.raises(RuntimeError, match="outside"):
        chip_smoke.check_sample(bad, np.asarray(jets.mask), 9)
