"""The port's ``Trainer`` over four gloo ranks on the CPU against the JAX
``Trainer`` on a 4-device host mesh with Auto axes (ROADMAP.md F1), at
smoke size in float32: WAGMA and Allreduce-SGD over ``data`` 4, and WAGMA
over pod 2 x data 2 under ``Topology.hierarchical`` (``--pod-dcn``).  Both
start from one state: the JAX run saves its initial ``ReplicaState`` with
the JAX checkpoint writer, and every rank loads it with the port's
``load_replica_state`` and keeps its own row.  Per-step losses and the
gathered final params and momenta are held within 1e-5 (of each leaf's
largest magnitude), the tolerance of tests/test_torch_train.py; counts,
step and phase exactly.  Then the launcher under torchrun (``--pod-axis``,
``--pod-dcn``, ``--ckpt-dir`` and ``--model-axis``) and the flags that
still raise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import rank_runs
from jax_trainer_runs import one_torch_thread  # noqa: F401
from subproc import SRC, run_sub

from repro_torch.checkpoint import load_replica_state
from repro_torch.configs import get_config
from repro_torch.core import tree as tr
from repro_torch.launch import train as train_mod

RTOL = 1e-5
ARCH, SEQ, GB, STEPS, TAU = "tinyllama-1.1b", 16, 8, 6, 5
# name -> (data, pod, Trainer kwargs); --pod-dcn compiles the hierarchical
# topology, as the reference's main does
RUNS = {
    "wagma": (4, None, dict(averager="wagma", tau=TAU)),
    "allreduce": (4, None, dict(averager="allreduce")),
    "pod_dcn": (2, 2, dict(averager="wagma", tau=TAU)),
}

JAX_RUNS = """
    from jax.sharding import AxisType
    from repro.checkpoint import save_replica_state
    from repro.configs import get_config
    from repro.core.group_allreduce import dp_axis_layout
    from repro.core.plan import Topology
    from repro.launch.train import Trainer
    from repro.train import dp_axes_of

    cfg = get_config({arch!r}, smoke=True).variant(dtype="float32")
    for name, (data, pod, kw) in {runs!r}.items():
        if pod:
            mesh = jax.make_mesh((pod, data, 1), ("pod", "data", "model"),
                                 axis_types=(AxisType.Auto,) * 3)
            names, sizes = dp_axis_layout(mesh.axis_names, dict(mesh.shape),
                                          dp_axes_of(mesh))
            kw = dict(kw, topology=Topology.hierarchical(
                names, sizes, dcn_axes=("pod",)))
        else:
            mesh = jax.make_mesh((data, 1), ("data", "model"),
                                 axis_types=(AxisType.Auto,) * 2)
        tr = Trainer(cfg, mesh, seq_len={seq}, global_batch={gb}, seed=0,
                     **kw)
        save_replica_state(f"{out}/{{name}}/init", jax.device_get(tr.state))
        with compat.set_mesh(mesh):
            losses = [tr.step_once(t) for t in range({steps})]
        save_replica_state(f"{out}/{{name}}/final", jax.device_get(tr.state))
        np.save(f"{out}/{{name}}/losses.npy", np.asarray(losses))
    print("JAX_RUNS_DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("train_ranks"))
    res = run_sub(JAX_RUNS.format(arch=ARCH, runs=RUNS, seq=SEQ, gb=GB,
                                  steps=STEPS, out=out), devices=4,
                  timeout=600)
    assert "JAX_RUNS_DONE" in res
    ranks = {}
    for name, (data, pod, kw) in RUNS.items():
        ranks[name] = rank_runs.spawn(
            "trainer", data * (pod or 1), os.path.join(out, name, "ranks"),
            data=data, pod=pod, arch=ARCH, init=os.path.join(out, name,
                                                             "init"),
            trainer_kw=dict(kw, seq_len=SEQ, global_batch=GB, seed=0),
            steps=STEPS, pod_dcn=bool(pod))
    return out, ranks


def _load(cfg, path):
    return load_replica_state(path, rank_runs.state_template(cfg, 4, {}))


@pytest.mark.parametrize("name", list(RUNS))
def test_rank_trainer_matches_jax_trainer(runs, name):
    out, ranks = runs
    cfg = get_config(ARCH, smoke=True).variant(dtype="float32")
    want_losses = np.load(os.path.join(out, name, "losses.npy"))
    for r in ranks[name]:          # every rank reports the global mean
        np.testing.assert_allclose(r["losses"], want_losses, rtol=RTOL,
                                   atol=RTOL)
        assert float(r["skipped"]) == 0
    got = _load(cfg, os.path.join(out, name, "ranks", "gathered"))
    want = _load(cfg, os.path.join(out, name, "final"))
    assert (got.step, got.phase) == (want.step, want.phase) == \
        tuple(ranks[name][0]["step_phase"])
    assert torch.equal(got.opt_state.count, want.opt_state.count)
    for tag, g_tree, w_tree in (("params", got.params, want.params),
                                ("momentum", got.opt_state.momentum,
                                 want.opt_state.momentum)):
        for g, w in zip(tr.tree_leaves(g_tree), tr.tree_leaves(w_tree)):
            scale = float(w.abs().max()) or 1.0
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                       atol=RTOL * scale, err_msg=tag)


def test_init_checkpoint_round_trips_through_the_port(runs, tmp_path):
    """The JAX-written initial state loads into the port and is written
    back with identical arrays and crc32s (tests/test_torch_ckpt.py holds
    the format on small trees)."""
    import json
    from repro_torch.checkpoint import save_replica_state
    out, _ = runs
    cfg = get_config(ARCH, smoke=True).variant(dtype="float32")
    src = os.path.join(out, "pod_dcn", "init")
    save_replica_state(str(tmp_path), _load(cfg, src))
    for f in ("params.npz", "opt_state.npz"):
        a, b = np.load(os.path.join(src, f)), np.load(tmp_path / f)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ma = json.load(open(os.path.join(src, "manifest.json")))
    mb = json.load(open(tmp_path / "manifest.json"))
    assert ma == mb


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _torchrun(n, *args, timeout=rank_runs.TIMEOUT):
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
         *args], capture_output=True, text=True, env=env, timeout=timeout)


def test_cli_under_torchrun_trains_pods_and_checkpoints(tmp_path):
    """Two ranks laid over pod 2 x data 1 with the hierarchical topology;
    ``--ckpt-dir`` writes the gathered state every 50 steps (the
    reference's period): after step 50, a tau-sync step, both rows agree."""
    ckpt = tmp_path / "ckpt"
    out = _torchrun(2, "--arch", ARCH, "--smoke", "--data-axis", "1",
                    "--pod-axis", "2", "--pod-dcn", "--steps", "50",
                    "--seq-len", "8", "--global-batch", "2",
                    "--ckpt-dir", str(ckpt))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.count("final loss") == 1       # rank 0 logs
    cfg = get_config(ARCH, smoke=True)
    state = load_replica_state(str(ckpt), rank_runs.state_template(cfg, 2,
                                                                   {}))
    assert state.step == 50 and state.phase == -1
    assert state.opt_state.count.tolist() == [50, 50]
    for leaf in tr.tree_leaves(state.params):
        assert torch.equal(leaf[0], leaf[1])


def test_cli_under_torchrun_trains_a_model_axis(tmp_path):
    """Four ranks as data 2 x model 2: rank 0 logs, and the gathered
    checkpoint holds whole leaves of the model-1 shapes."""
    ckpt = tmp_path / "ckpt"
    out = _torchrun(4, "--arch", ARCH, "--smoke", "--data-axis", "2",
                    "--model-axis", "2", "--steps", "50", "--tau", "5",
                    "--seq-len", "8", "--global-batch", "4",
                    "--ckpt-dir", str(ckpt))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert out.stdout.count("final loss") == 1
    cfg = get_config(ARCH, smoke=True)
    state = load_replica_state(str(ckpt), rank_runs.state_template(cfg, 2,
                                                                   {}))
    assert state.step == 50 and state.phase == -1
    for leaf in tr.tree_leaves(state.params):
        assert torch.equal(leaf[0], leaf[1])


def test_a_rank_that_fails_fails_torchrun():
    # 3 ranks cannot tile data 2: every rank raises, torchrun exits non-zero
    out = _torchrun(3, "--arch", ARCH, "--smoke", "--data-axis", "2",
                    "--steps", "1", "--seq-len", "8", "--global-batch", "2")
    assert out.returncode != 0
    assert "the world has 3 ranks" in out.stdout + out.stderr


def _main(monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", ["train", *argv])
    train_mod.main()


def test_model_axis_raises_naming_slice_4b(monkeypatch):
    """Slices 4b and 4c ported the model axis of every family, under
    torchrun: each in one process exits saying how to start it."""
    for arch in ("tinyllama-1.1b", "recurrentgemma-2b", "whisper-medium",
                 "internvl2-2b", "xlstm-350m", "kimi-k2-1t-a32b"):
        with pytest.raises(SystemExit, match="torchrun"):
            _main(monkeypatch, "--arch", arch, "--smoke", "--data-axis",
                  "4", "--model-axis", "2")


def test_nccl_with_more_local_ranks_than_cards_raises(monkeypatch):
    for k, v in dict(WORLD_SIZE="4", RANK="1", LOCAL_RANK="1",
                     LOCAL_WORLD_SIZE="4", REPRO_TORCH_BACKEND="nccl",
                     REPRO_TORCH_DEVICE="cuda").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per local rank"):
        _main(monkeypatch, "--smoke", "--data-axis", "4")
