"""True multi-process execution (VERDICT r2 #5): 2 local processes x 4
virtual CPU devices, coordinated via `jax.distributed.initialize` with
gloo CPU collectives.

The `jax.process_count() > 1` branches (`parallel/mesh.py:66-86`,
`sampling/generator.py:gather_multihost`, `sync_hosts`) stop being dead
code: each worker shards the shared global batch with
`make_array_from_process_local_data`, runs a sharded loss + train step
(gradient all-reduce across processes), generates its slice of the jets,
and all-gathers the samples.  The parent asserts loss parity with the
single-process 8-device run on the identical batch.

Marked slow: two fresh JAX processes + gloo rendezvous take ~1 min.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_parity(tmp_path):
    port = _free_port()
    outs = [str(tmp_path / f"w{i}.json") for i in range(2)]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own 4-device flag
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "mp_worker.py"),
             str(i), "2", str(port), outs[i]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)
        for i in range(2)
    ]
    logs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        logs.append(out)
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{lg[-3000:]}"

    results = [json.load(open(o)) for o in outs]

    # both processes agree on the (psum-reduced, replicated) global loss
    np.testing.assert_allclose(results[0]["loss"], results[1]["loss"], rtol=1e-6)
    np.testing.assert_allclose(results[0]["loss_after_grad"],
                               results[1]["loss_after_grad"], rtol=1e-6)
    # the train step moved the (replicated) params identically on each host
    assert results[0]["param_delta_l1"] > 0
    np.testing.assert_allclose(results[0]["param_delta_l1"],
                               results[1]["param_delta_l1"], rtol=1e-5)
    # gather_multihost returned ALL jets to every process, identically
    assert results[0]["gathered_jets"] == results[1]["gathered_jets"] == 16
    np.testing.assert_allclose(results[0]["gathered_checksum"],
                               results[1]["gathered_checksum"], rtol=1e-6)

    # ---- single-process 8-device reference on the identical batch ------
    import jax

    from multimodal_flows.parallel.mesh import (
        make_mesh,
        replicated_sharding,
        shard_coupling,
    )
    from multimodal_flows.train.systems import MMF
    from tests.mp_common import make_global_coupling, tiny_mp_config

    assert jax.device_count() == 8  # conftest virtual mesh
    cfg = tiny_mp_config()
    system = MMF(cfg)
    mesh = make_mesh()
    batch = shard_coupling(make_global_coupling(), mesh)
    params = jax.device_put(system.init_params(jax.random.PRNGKey(0)),
                            replicated_sharding(mesh))
    loss_1proc, _ = jax.jit(
        lambda p, b: system.loss_fn(p, b, jax.random.PRNGKey(42), train=False)
    )(params, batch)

    np.testing.assert_allclose(results[0]["loss"], float(loss_1proc), rtol=1e-5)


def _run_phase(tmp_path, phase, ckpt_dir):
    port = _free_port()
    outs = [str(tmp_path / f"{phase}{i}.json") for i in range(2)]
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(REPO, "tests", "mp_worker_r04.py"),
             str(i), "2", str(port), outs[i], phase, ckpt_dir],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO)
        for i in range(2)
    ]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, lg in zip(procs, logs):
        assert p.returncode == 0, f"{phase} worker failed:\n{lg[-3000:]}"
    return [json.load(open(o)) for o in outs]


@pytest.mark.slow
def test_two_process_fsdp_tp_ckpt_packed(tmp_path):
    """VERDICT r3 #8: FSDP + TP state/step, checkpoint save/restore across
    a process RESTART, and a packed-generation multihost gather — all on
    the 2-process x 4-device gloo harness."""
    ckpt_dir = str(tmp_path / "ckpts")

    r = _run_phase(tmp_path, "train", ckpt_dir)
    # FSDP: kernels really sharded; both processes agree on loss + params
    assert r[0]["fsdp_any_sharded"] and r[1]["fsdp_any_sharded"]
    np.testing.assert_allclose(r[0]["fsdp_loss"], r[1]["fsdp_loss"], rtol=1e-6)
    np.testing.assert_allclose(r[0]["fsdp_fingerprint"],
                               r[1]["fsdp_fingerprint"], rtol=1e-6)
    # TP: model-axis sharding active, loss agreed
    assert r[0]["tp_any_sharded"] and r[1]["tp_any_sharded"]
    np.testing.assert_allclose(r[0]["tp_loss"], r[1]["tp_loss"], rtol=1e-6)
    # packed generation gathered ALL jets identically on each process
    assert r[0]["packed_gathered_jets"] == r[1]["packed_gathered_jets"] == 16
    np.testing.assert_allclose(r[0]["packed_checksum"], r[1]["packed_checksum"],
                               rtol=1e-6)
    assert r[0]["packed_mult_total"] > 0

    # ---- process restart: fresh pair restores the FSDP checkpoint ------
    r2 = _run_phase(tmp_path, "restore", ckpt_dir)
    for w in r2:
        assert w["restored_epoch"] == 1
        assert w["restored_still_sharded"]
        assert np.isfinite(w["post_restore_loss"])
    # the restored params are bit-consistent with what phase 1 saved
    np.testing.assert_allclose(r2[0]["restored_fingerprint"],
                               r[0]["fsdp_fingerprint"], rtol=1e-6)
    np.testing.assert_allclose(r2[0]["restored_fingerprint"],
                               r2[1]["restored_fingerprint"], rtol=1e-6)
