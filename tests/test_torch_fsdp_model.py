"""FSDP within a pod under a model axis (``ShardingPolicy.fsdp_within_pod
("data")`` over a rank world with ``model`` 2): each gloo rank is one
member of its pod at one model coordinate and holds its shard slice of
that coordinate's buckets (the sharded plan compiled over its slice
tree).

Every rank check runs in one world of pod 2 x data 2 x model 2 gloo ranks
on the CPU (``rank_runs.fsdp_model_worker``, smoke tinyllama-1.1b in
float32), warm-started from the JAX ``Trainer``'s initial state:

* 3 steps (the sync at t = 2), gather-all and layer-streamed: the losses
  and the gathered state, in the model-1 layout, within 1e-5 of the JAX
  ``Trainer(sharding="fsdp", streamed=...)`` on an Auto (pod 2, data 2,
  model 2) mesh of 8 host devices (ROADMAP.md F1); the streamed run
  equal to the gather-all one, losses and state, bit for bit;
* one group step whose pod view pairs each rank with the other model
  coordinate's members (planted) parts from the right one;
* a NaN in one member's gradient at model rank 1 skips all four ranks of
  its pod, and a guard without the MIN over the model group (planted)
  parts the skip counts within a model group.

Then the launcher under torchrun (``--model-axis 2 --sharding fsdp
--ckpt-dir``): its checkpoint restores into a model-1 run.
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
from repro_torch.core import bucketing
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.core.plan import Topology
from repro_torch.core.replica import ShardingPolicy
from repro_torch.launch.train import Trainer
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model

ARCH, DATA, POD, MODEL, S, TAU, SEQ, GB, STEPS = ("tinyllama-1.1b", 2, 2,
                                                  2, 2, 3, 16, 8, 3)
JAX_RTOL = 1e-5          # against the JAX Trainer (tests/test_torch_fsdp.py)
BAD = 3                  # a member of pod 1 (dp ranks 2 and 3)
RUN = dict(averager="wagma", group_size=S, tau=TAU)
TAGS = {"gather_all": False, "streamed": True}
N = DATA * POD * MODEL

JAX_RUNS = """
    from jax.sharding import AxisType
    from repro.checkpoint import save_replica_state
    from repro.configs import get_config
    from repro.core.plan import Topology
    from repro.core.replica import ShardingPolicy
    from repro.launch.train import Trainer

    cfg = get_config({arch!r}, smoke=True).variant(dtype="float32")
    mesh = jax.make_mesh(({pod}, {data}, {model}), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    topo = Topology.hierarchical(("data", "pod"), ({data}, {pod}),
                                 dcn_axes=("pod",))
    for tag, streamed in {tags!r}.items():
        fsdp = ShardingPolicy.fsdp_within_pod("data", streamed=streamed)
        tr = Trainer(cfg, mesh, seq_len={seq}, global_batch={gb}, seed=0,
                     topology=topo, sharding="fsdp", streamed=streamed,
                     **{run!r})
        save_replica_state(f"{out}/{{tag}}/init", jax.device_get(tr.state),
                           sharding=fsdp)
        with compat.set_mesh(mesh):
            losses = [tr.step_once(t) for t in range({steps})]
        save_replica_state(f"{out}/{{tag}}/final", jax.device_get(tr.state),
                           sharding=fsdp)
        np.save(f"{out}/{{tag}}/losses.npy", np.asarray(losses))
    print("JAX_FSDP_MODEL_RUNS_DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fsdp_model"))
    res = run_sub(JAX_RUNS.format(arch=ARCH, tags=TAGS, run=RUN, seq=SEQ,
                                  gb=GB, steps=STEPS, out=out, data=DATA,
                                  pod=POD, model=MODEL),
                  devices=N, timeout=900)
    assert "JAX_FSDP_MODEL_RUNS_DONE" in res
    ranks = rank_runs.spawn(
        "fsdp_model", N, os.path.join(out, "ranks"), timeout=600,
        data=DATA, pod=POD, model=MODEL, shard_axis="data",
        inits={t: os.path.join(out, t, "init") for t in TAGS},
        trainer_kw=RUN, seq_len=SEQ, global_batch=GB, steps=STEPS, bad=BAD)
    return out, ranks


def _launch(n, *args, timeout):
    """The launcher under torchrun on ``n`` CPU ranks."""
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "repro_torch.launch.train",
         *args], capture_output=True, text=True, env=env, timeout=timeout)


def _topology():
    return Topology.hierarchical(("data", "pod"), (DATA, POD),
                                 dcn_axes=("pod",))


def _twin(streamed=False, **kw):
    """The one-process model-1 FSDP Trainer (no state yet)."""
    return Trainer(rank_runs.smoke_cfg(ARCH), DATA, pod_axis=POD,
                   device="cpu", seq_len=SEQ, global_batch=GB, seed=0,
                   sharding="fsdp", streamed=streamed, topology=_topology(),
                   **dict(RUN, **kw))


def _load(trainer, path):
    return load_replica_state(path, rank_runs.fsdp_state_template(
        trainer.cfg, trainer.plan()), sharding=trainer.sharding)


def _canonical(trainer, state):
    """A model-1 FSDP state's pod trees, params and momentum, merged to
    the canonical tree (a streamed state through the layered tree)."""
    out = []
    for bufs in (state.params, state.opt_state.momentum):
        tree = bucketing.unpack(tuple(bufs), trainer.plan().shard_layout,
                                cast=False)
        if trainer.sharding.streamed:
            tree = trainer.model.layered.merge(tree, lead=1)
        out.append(tree)
    return out


def _close(got, want, rtol=JAX_RTOL) -> bool:
    for g, w in zip(tr.tree_leaves(got), tr.tree_leaves(want)):
        scale = float(w.float().abs().max()) or 1.0
        if not np.allclose(g.float().numpy(), w.float().numpy(), rtol=rtol,
                           atol=rtol * scale):
            return False
    return True


@pytest.mark.parametrize("tag", list(TAGS))
def test_model_world_matches_the_jax_fsdp_trainer(runs, tag):
    """Three steps over pod 2 x data 2 x model 2 ranks: every rank's
    losses within 1e-5 of the JAX ``Trainer`` on the Auto (pod 2, data 2,
    model 2) mesh, and the gathered checkpoint, in the model-1 run's
    layout, within 1e-5 of each buffer's largest magnitude; counts, step
    and phase exactly, no skip."""
    out, ranks = runs
    want_losses = np.load(os.path.join(out, tag, "losses.npy"))
    for r in ranks:
        np.testing.assert_allclose(r[f"{tag}/losses"], want_losses,
                                   rtol=JAX_RTOL, atol=JAX_RTOL)
        assert float(r[f"{tag}/skipped"]) == 0
    twin = _twin(TAGS[tag])
    got = _load(twin, os.path.join(out, "ranks", tag))
    want = _load(twin, os.path.join(out, tag, "final"))
    assert [tuple(b.shape) for b in got.params] == \
        [(POD, n) for n in twin.plan().shard_layout.bucket_sizes]
    assert (got.step, got.phase) == (want.step, want.phase) == (STEPS, -1)
    assert torch.equal(got.opt_state.count, want.opt_state.count)
    assert got.opt_state.count.tolist() == [STEPS] * POD
    for g, w in zip(got.params + got.opt_state.momentum,
                    want.params + want.opt_state.momentum):
        scale = float(w.float().abs().max()) or 1.0
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=JAX_RTOL, atol=JAX_RTOL * scale)


def test_streamed_equals_gather_all_over_the_model_world(runs):
    """The streamed engine over the model world: every rank's losses
    ``==`` the gather-all run's, its event logs held to the schedule on
    every step, and the final gathered states merged to the canonical
    tree equal leaf for leaf, bit for bit.  Each rank holds ``(1, n_b /
    2)`` of its model coordinate's buckets: the layout of the slice
    tree's plan, not the whole tree's."""
    out, ranks = runs
    for r in ranks:
        assert np.array_equal(r["streamed/losses"], r["gather_all/losses"])
        assert int(r["streamed/logs"]) == STEPS
    states = {}
    for tag, streamed in TAGS.items():
        twin = _twin(streamed)
        states[tag] = _canonical(twin, _load(twin, os.path.join(
            out, "ranks", tag)))
    for a, b in zip(tr.tree_leaves(states["streamed"]),
                    tr.tree_leaves(states["gather_all"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    cfg = rank_runs.smoke_cfg(ARCH)
    specs = rank_runs._spec_tree(cfg)
    mw = cm.ModelWorld(MODEL, 0)
    sliced = cm.take_slices(specs, cm.placement(cfg, specs, MODEL), mw)
    layered = build_model(cfg, "cpu").layered
    for tag, streamed in TAGS.items():
        tree = layered.split(sliced) if streamed else sliced
        plan = plan_mod.compile_plan(
            _topology(), tree, plan_mod.AveragingConfig(group_size=S,
                                                        tau=TAU),
            ShardingPolicy.fsdp_within_pod("data", streamed=streamed))
        assert plan.shard_layout.grouped == streamed
        for r in ranks:
            assert r[f"{tag}/slices"].tolist() == [
                n // DATA for n in plan.shard_layout.bucket_sizes]


def test_a_pod_view_at_the_other_model_coordinate_parts(runs):
    """One group step from the JAX initial state: the model world's
    gathered state within 1e-5 of the one-process model-1 step's; with
    each rank's butterfly partners at the other model coordinate
    (planted: two coordinates' slices averaged together) it parts."""
    out, _ = runs
    twin = _twin()
    twin.state = twin._put_state(_load(twin, os.path.join(
        out, "gather_all", "init")))
    twin.step_once(0)
    want = (twin.state.params, twin.state.opt_state.momentum)
    for tag, close in (("one_step", True), ("mispaired", False)):
        got = _load(twin, os.path.join(out, "ranks", tag))
        assert _close((got.params, got.opt_state.momentum), want) is close


def test_a_nan_at_one_model_rank_skips_its_whole_pod(runs):
    """A NaN in member BAD's gradient at model rank 1 alone: under the MIN
    over the model group, then over the pod, all four ranks of pod 1 skip
    and pod 0 updates; a guard without the model group's MIN (planted)
    skips pod 1's model rank 1 only, so a model group's counts part."""
    _, ranks = runs
    pod_of = lambda torch_rank: torch_rank // MODEL // DATA
    counts = {k: [int(r[f"{k}/count"][0]) for r in ranks]
              for k in ("guard", "pod_min_only")}
    assert counts["guard"] == [0 if pod_of(t) == 1 else 1 for t in range(N)]
    assert float(ranks[0]["guard/skipped"]) == DATA / (DATA * POD)
    assert counts["pod_min_only"] == [
        0 if pod_of(t) == 1 and t % MODEL == 1 else 1 for t in range(N)]
    bad = counts["pod_min_only"][BAD * MODEL:(BAD + 1) * MODEL]
    assert sorted(bad) == [0, 1]


def test_cli_model_axis_fsdp_checkpoint_restores_into_model_1(tmp_path):
    """``--model-axis 2 --sharding fsdp --pod-dcn --ckpt-dir`` over 8
    ranks writes at step 50 a checkpoint in the model-1 run's layout: it
    restores into the one-process FSDP Trainer, which runs on."""
    args = ["--arch", ARCH, "--smoke", "--data-axis", str(DATA),
            "--pod-axis", str(POD), "--model-axis", str(MODEL), "--pod-dcn",
            "--sharding", "fsdp", "--group-size", "2", "--tau", "5",
            "--steps", "50", "--seq-len", "8", "--global-batch", "8",
            "--ckpt-dir", str(tmp_path / "ckpt")]
    proc = _launch(N, *args, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert proc.stdout.count("final loss") == 1
    cfg = get_config(ARCH, smoke=True)
    trainer = Trainer(cfg, DATA, pod_axis=POD, device="cpu", seq_len=8,
                      global_batch=8, sharding="fsdp", group_size=2, tau=5,
                      topology=_topology())
    state = _load(trainer, str(tmp_path / "ckpt"))
    assert state.step == 50 and state.opt_state.count.tolist() == [50] * POD
    trainer.state = trainer._put_state(state)
    assert rank_runs._states_equal(trainer.state, state)
    assert np.isfinite(trainer.step_once(50))
