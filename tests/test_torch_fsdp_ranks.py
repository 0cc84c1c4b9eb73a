"""Gather-all FSDP within a pod over a rank world (``ShardingPolicy.
fsdp_within_pod("data")`` with ``world=``): each gloo rank is one member of
its pod and holds its column slice of the pod's shard buckets.

Every rank check runs in one world of 8 gloo ranks on the CPU
(``rank_runs.fsdp_ranks_worker``, smoke tinyllama-1.1b in float32):

* the plan over data 2 x pod 4 and over data 4 x pod 2 (pod size 4, where
  the order of the reduce-scatter's adds shows): ``shard_tree``,
  ``unshard_tree`` (the all-gather), ``grad_shards`` (the reduce-scatter),
  ``_average_sharded`` on every offset, flat and hierarchical, overlapped
  and serial, ``sync`` and the pod wire's ``ring_shift`` and
  ``pmean_rows``, each ``torch.equal`` to the one-process plan's
  (``tests/test_torch_fsdp.py`` holds that one to the JAX plan); a
  reduce-scatter adding the members in reverse order must part at pod
  size 4;
* 6 steps of ``Trainer(world=..., sharding="fsdp")`` under ``wagma`` and
  ``allreduce`` from the JAX ``Trainer``'s initial state: the gathered
  final state bit for bit the one-process FSDP ``Trainer``'s, the losses
  within 1e-6 relative of it, and within 1e-5 of the JAX ``Trainer`` on 8
  host devices with Auto axes (ROADMAP.md F1);
* one step whose batch poisons one member's rows skips its whole pod, as
  on one process; one NaN element in one member's gradient lands in one
  slice, and a guard without the MIN over the pod leaves the pod's two
  members out of step.

Then the launcher under torchrun (``--sharding fsdp --pod-dcn
--ckpt-dir``) against the one-process launcher; under torchrun
``--streamed`` (slice 7c-2) and a model axis with FSDP (slice 7c-3) pass
its checks.
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
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.core.replica import (FSDP_MODEL_SLICE, FSDP_STREAMED_SLICE,
                                      ShardingPolicy, effective_rank_map,
                                      pod_members)
from repro_torch.core.plan import Topology
from repro_torch.launch import train as train_mod
from repro_torch.launch.train import Trainer

ARCH, DATA, POD, S, TAU, SEQ, GB, STEPS = ("tinyllama-1.1b", 2, 4, 2, 5, 16,
                                           16, 6)
LOSS_RTOL = 1e-6         # the ranks against the one-process twin
JAX_RTOL = 1e-5          # against the JAX Trainer (tests/test_torch_fsdp.py)
BAD = 3                  # a member of pod 1 (ranks 2 and 3)
FSDP = ShardingPolicy.fsdp_within_pod("data")
RUNS = {"wagma": dict(averager="wagma", group_size=S, tau=TAU),
        "allreduce": dict(averager="allreduce")}
# the plan checks' tree (tests/test_replica.py's: f32, bf16, an empty leaf)
TREE = {"emb": ((33, 70), "float32"), "w": ((1300,), "float32"),
        "h": ((300,), "bfloat16"), "e": ((0, 4), "float32")}
LAYOUTS = {"2x4": (2, 4), "4x2": (4, 2)}       # (data, pod)

JAX_RUNS = """
    from jax.sharding import AxisType
    from repro.checkpoint import save_replica_state
    from repro.configs import get_config
    from repro.core.plan import Topology
    from repro.core.replica import ShardingPolicy
    from repro.launch.train import Trainer

    cfg = get_config({arch!r}, smoke=True).variant(dtype="float32")
    mesh = jax.make_mesh(({pod}, {data}, 1), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    topo = Topology.hierarchical(("data", "pod"), ({data}, {pod}),
                                 dcn_axes=("pod",))
    fsdp = ShardingPolicy.fsdp_within_pod("data")
    for name, kw in {runs!r}.items():
        tr = Trainer(cfg, mesh, seq_len={seq}, global_batch={gb}, seed=0,
                     topology=topo, sharding="fsdp", **kw)
        save_replica_state(f"{out}/{{name}}/init", jax.device_get(tr.state),
                           sharding=fsdp)
        with compat.set_mesh(mesh):
            losses = [tr.step_once(t) for t in range({steps})]
        save_replica_state(f"{out}/{{name}}/final", jax.device_get(tr.state),
                           sharding=fsdp)
        np.save(f"{out}/{{name}}/losses.npy", np.asarray(losses))
    print("JAX_FSDP_RUNS_DONE")
"""


def _inputs():
    """The plan checks' numpy inputs a layout: the pods' trees, every
    member's gradient (bf16 leaves rounded to bf16) and a float32 row a
    rank for the pod wire."""
    rng = np.random.default_rng(0)
    out = {}
    for lay, (data, pod) in LAYOUTS.items():
        for k, (shape, d) in TREE.items():
            for key, n in (("pods", pod), ("grads", data * pod)):
                a = rng.standard_normal((n,) + shape).astype(np.float32)
                if d == "bfloat16":
                    a = torch.from_numpy(a).bfloat16().float().numpy()
                out[f"{lay}/{key}/{k}"] = a
        out[f"{lay}/wire"] = rng.standard_normal((8, 257)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("fsdp_ranks"))
    res = run_sub(JAX_RUNS.format(arch=ARCH, runs=RUNS, seq=SEQ, gb=GB,
                                  steps=STEPS, out=out, data=DATA, pod=POD),
                  devices=DATA * POD, timeout=900)
    assert "JAX_FSDP_RUNS_DONE" in res
    inputs = _inputs()
    np.savez(os.path.join(out, "inputs.npz"), **inputs)
    ranks = rank_runs.spawn(
        "fsdp_ranks", DATA * POD, os.path.join(out, "ranks"), timeout=600,
        data=DATA, pod=POD, shard_axis="data",
        tree={k: (list(s), d) for k, (s, d) in TREE.items()},
        inputs=os.path.join(out, "inputs.npz"), arch=ARCH,
        inits={n: os.path.join(out, n, "init") for n in RUNS}, runs=RUNS,
        seq_len=SEQ, global_batch=GB, steps=STEPS, bad=BAD)
    return out, inputs, ranks


def _cfg():
    return rank_runs.smoke_cfg(ARCH)


def _trainer(name):
    """The one-process FSDP Trainer of run ``name`` (no state yet)."""
    return Trainer(_cfg(), DATA, pod_axis=POD, device="cpu", seq_len=SEQ,
                   global_batch=GB, seed=0, sharding="fsdp",
                   topology=Topology.hierarchical(("data", "pod"),
                                                  (DATA, POD),
                                                  dcn_axes=("pod",)),
                   **RUNS[name])


def _load(trainer, path):
    return load_replica_state(path, rank_runs.fsdp_state_template(
        trainer.cfg, trainer.plan()), sharding=FSDP)


def _twin(out, name, steps=STEPS):
    """The one-process FSDP Trainer of run ``name`` from the JAX run's
    initial state after ``steps`` steps, and its losses."""
    trainer = _trainer(name)
    trainer.state = trainer._put_state(_load(trainer, os.path.join(
        out, name, "init")))
    return trainer, [trainer.step_once(t) for t in range(steps)]


def _states_equal(a, b) -> bool:
    la = tr.tree_leaves((a.params, a.opt_state))
    lb = tr.tree_leaves((b.params, b.opt_state))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# The plan over ranks against the one-process plan
# ---------------------------------------------------------------------------

def _one_process(lay, topo, mode):
    """The one-process sharded plan of a plan check, its ``(P_eff, n_b)``
    buffers of the pods' trees and the members' gradients."""
    data, pod = LAYOUTS[lay]
    specs = {k: tr.Spec(s, getattr(torch, d)) for k, (s, d) in TREE.items()}
    plan = plan_mod.compile_plan(
        rank_runs.fsdp_topology(topo, (data, pod), 4096), specs,
        plan_mod.AveragingConfig(group_size=2, overlap=mode == "overlap"),
        FSDP)
    return plan, specs


def _slice(buf, coord, size):
    n = buf.shape[-1] // size
    return buf[..., coord * n:(coord + 1) * n]


@pytest.mark.parametrize("mode", ["overlap", "serial"])
@pytest.mark.parametrize("topo", ["flat", "hier"])
@pytest.mark.parametrize("lay", list(LAYOUTS))
def test_plan_over_ranks_equals_the_one_process_plan(runs, lay, topo, mode):
    """Each rank's slices of ``shard_tree``, of ``_average_sharded`` on
    every offset, of ``sync`` and of ``grad_shards``, and its pod's
    ``unshard_tree``, ``torch.equal`` to the one-process plan's."""
    _, inputs, ranks = runs
    data, _ = LAYOUTS[lay]
    plan, specs = _one_process(lay, topo, mode)
    pods = {k: torch.from_numpy(inputs[f"{lay}/pods/{k}"]).to(
        specs[k].dtype) for k in TREE}
    grads = {k: torch.from_numpy(inputs[f"{lay}/grads/{k}"]).to(
        specs[k].dtype) for k in TREE}
    bufs = plan.shard_tree(pods)
    assert plan.shard_layout.n_buckets > 1
    assert len(plan.offsets) == (2 if lay == "2x4" else 1)
    averaged = {off: plan._average_sharded(bufs, off) for off in plan.offsets}
    eff = effective_rank_map(LAYOUTS[lay], 0)
    key = f"{lay}/{topo}/{mode}"
    for r, res in enumerate(ranks):
        pod, coord = int(eff[r]), r % data
        mine = lambda b: _slice(b[pod], coord, data).float().numpy()
        for b, buf in enumerate(bufs):
            assert np.array_equal(res[f"{key}/shard/{b}"][0], mine(buf))
        for off, out in averaged.items():
            for b, buf in enumerate(out):
                assert np.array_equal(res[f"{key}/avg/{off}/{b}"][0],
                                      mine(buf)), (r, off, b)
        if mode == "serial":
            continue
        tree = plan.unshard_tree(bufs, pod)
        for k in TREE:
            assert np.array_equal(res[f"{key}/unshard/{k}"][0],
                                  tree[k].float().numpy())
        want = plan.grad_shards({k: v[m] for k, v in grads.items()}
                                for m in pod_members(plan, pod))
        for b, buf in enumerate(want):
            assert np.array_equal(res[f"{key}/grads/{b}"],
                                  _slice(buf, coord, data).numpy()), (r, b)
        for b, buf in enumerate(plan.sync(bufs)):
            assert np.array_equal(res[f"{key}/sync/{b}"][0], mine(buf))


@pytest.mark.parametrize("lay", list(LAYOUTS))
def test_pod_wire_ring_and_mean_equal_the_stacked_rows(runs, lay):
    """The pod view's ring shift and mean at each shard coordinate equal
    the stacked primitives on that coordinate's rows in pod order."""
    _, inputs, ranks = runs
    data, pod = LAYOUTS[lay]
    rows = torch.from_numpy(inputs[f"{lay}/wire"])
    eff = effective_rank_map(LAYOUTS[lay], 0)
    for r, res in enumerate(ranks):
        coord = rows[[m for m in range(data * pod) if m % data == r % data]]
        assert torch.equal(torch.from_numpy(res[f"{lay}/ring"][0]),
                           plan_mod.ring_shift(coord, 1, pod)[eff[r]])
        assert torch.equal(torch.from_numpy(res[f"{lay}/pmean"][0]),
                           plan_mod.pmean_rows(coord)[eff[r]])


def test_a_reverse_order_reduce_scatter_parts_at_pod_size_4(runs):
    """The planted fault: the members' slices added from the last to the
    first.  At pod size 2 one add commutes; at pod size 4 some slice
    parts from the one-process ``grad_shards``."""
    _, inputs, ranks = runs
    parted = {}
    for lay, (data, _) in LAYOUTS.items():
        plan, specs = _one_process(lay, "hier", "overlap")
        grads = {k: torch.from_numpy(inputs[f"{lay}/grads/{k}"]).to(
            specs[k].dtype) for k in TREE}
        eff = effective_rank_map(LAYOUTS[lay], 0)
        parted[lay] = False
        for r, res in enumerate(ranks):
            want = plan.grad_shards({k: v[m] for k, v in grads.items()}
                                    for m in pod_members(plan, int(eff[r])))
            for b, buf in enumerate(want):
                mine = _slice(buf, r % data, data).numpy()
                assert np.array_equal(res[f"{lay}/hier/overlap/grads/{b}"],
                                      mine)
                if not np.array_equal(
                        res[f"{lay}/hier/overlap/reversed/{b}"], mine):
                    parted[lay] = True
    assert parted == {"2x4": False, "4x2": True}


# ---------------------------------------------------------------------------
# The Trainer over ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RUNS))
def test_rank_trainer_equals_the_one_process_fsdp_trainer(runs, name):
    """Six steps over 8 ranks: every rank reports the one-process losses
    within 1e-6 relative, and the gathered checkpoint is the one-process
    FSDP Trainer's final state bit for bit (params, momentum, counts,
    step and phase)."""
    out, _, ranks = runs
    trainer, losses = _twin(out, name)
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}/losses"], losses,
                                   rtol=LOSS_RTOL, atol=0)
        assert float(r[f"{name}/skipped"]) == 0
    assert [bool(r[f"{name}/consolidated"]) for r in ranks] == \
        [False] + [True] * (DATA * POD - 1)
    got = _load(trainer, os.path.join(out, "ranks", name))
    assert (got.step, got.phase) == (trainer.state.step, trainer.state.phase)
    assert _states_equal(got, trainer.state)
    assert got.opt_state.count.tolist() == [STEPS] * POD


@pytest.mark.parametrize("name", list(RUNS))
def test_rank_trainer_matches_the_jax_fsdp_trainer(runs, name):
    """The ranks' losses and gathered final state within 1e-5 of the JAX
    ``Trainer(sharding="fsdp")`` on 8 host devices (each buffer to 1e-5
    of its largest magnitude); counts, step and phase exactly."""
    out, _, ranks = runs
    want_losses = np.load(os.path.join(out, name, "losses.npy"))
    np.testing.assert_allclose(ranks[0][f"{name}/losses"], want_losses,
                               rtol=JAX_RTOL, atol=JAX_RTOL)
    trainer = _trainer(name)
    got = _load(trainer, os.path.join(out, "ranks", name))
    want = _load(trainer, os.path.join(out, name, "final"))
    assert (got.step, got.phase) == (want.step, want.phase)
    assert torch.equal(got.opt_state.count, want.opt_state.count)
    for g, w in zip(tr.tree_leaves((got.params, got.opt_state.momentum)),
                    tr.tree_leaves((want.params, want.opt_state.momentum))):
        scale = float(w.float().abs().max()) or 1.0
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(),
                                   rtol=JAX_RTOL, atol=JAX_RTOL * scale)


def test_consolidated_over_ranks_is_the_one_process_consensus(runs):
    """``Trainer.consolidated()`` over ranks gathers the slices on rank 0
    and consolidates there (``None`` on the other ranks): the one-process
    FSDP Trainer's consensus model after the same steps, bit for bit."""
    out, _, ranks = runs
    trainer, _ = _twin(out, "wagma")
    want = rank_runs.flat_tree(trainer.consolidated())
    got = {k[len("wagma/cons/"):]: v for k, v in ranks[0].items()
           if k.startswith("wagma/cons/")}
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.array_equal(got[k], v.float().numpy()), k


def test_a_poisoned_member_skips_its_whole_pod_over_ranks(runs):
    """A NaN in member BAD's mask rows: its pod alone skips (count 0 on
    both members, its momentum as it was), every other pod updates, and
    the gathered state equals the one-process step's bit for bit.  A NaN
    in one element of BAD's gradient lands in one slice only; the MIN
    over the pod still skips both members."""
    out, _, ranks = runs
    trainer = _trainer("wagma")
    before = _load(trainer, os.path.join(out, "wagma", "init"))
    trainer.state = trainer._put_state(_load(trainer, os.path.join(
        out, "wagma", "init")))
    batch = trainer._put_batch(0)
    b = GB // (DATA * POD)
    batch["mask"] = torch.ones_like(batch["labels"], dtype=torch.float32)
    batch["mask"][BAD * b:(BAD + 1) * b] = float("nan")
    trainer.state, metrics = trainer._step_fn(0)(trainer.state, batch)
    bad_pod = BAD // DATA
    pod_counts = [0 if e == bad_pod else 1 for e in range(POD)]
    assert float(metrics["skipped_nonfinite"]) == DATA / (DATA * POD)
    got = _load(trainer, os.path.join(out, "ranks", "guard"))
    assert _states_equal(got, trainer.state)
    assert got.opt_state.count.tolist() == pod_counts
    member_counts = [c for c in pod_counts for _ in range(DATA)]
    for name in ("guard", "element"):
        assert [int(r[f"{name}/count"][0]) for r in ranks] == member_counts
        assert float(ranks[0][f"{name}/skipped"]) == DATA / (DATA * POD)
    # the skipped pod's momentum as it was (its params then averaged)
    element = _load(trainer, os.path.join(out, "ranks", "element"))
    for g, w in zip(element.opt_state.momentum, before.opt_state.momentum):
        assert torch.equal(g[bad_pod], w[bad_pod])
        assert not torch.equal(g[1 - bad_pod], w[1 - bad_pod])


def test_a_guard_without_the_pod_min_leaves_the_slices_out_of_step(runs):
    """The planted fault: the element's NaN reaches one member's slice
    only, and a guard without the MIN over the pod skips that member
    alone, so the pod's two members' counts part."""
    _, _, ranks = runs
    counts = [int(r["no_min/count"][0]) for r in ranks]
    bad_pod = BAD // DATA
    pod = counts[bad_pod * DATA:(bad_pod + 1) * DATA]
    assert sorted(pod) == [0, 1]
    assert float(ranks[0]["no_min/skipped"]) == 1 / (DATA * POD)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _launch(n, *args, timeout=rank_runs.TIMEOUT):
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args]
    if n > 1:
        cmd[1:3] = ["-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", str(n), "-m",
                    "repro_torch.launch.train"]
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=timeout)


def test_cli_fsdp_under_torchrun_checkpoints_as_one_process(tmp_path):
    """``--sharding fsdp --pod-dcn --ckpt-dir`` over 8 ranks (data 2 x pod
    4) writes at step 50 the checkpoint the one-process launcher writes,
    leaf for leaf; it restores into the FSDP Trainer and runs on."""
    args = ["--arch", ARCH, "--smoke", "--data-axis", str(DATA),
            "--pod-axis", str(POD), "--pod-dcn", "--sharding", "fsdp",
            "--group-size", "2", "--tau", "5", "--steps", "50",
            "--seq-len", "8", "--global-batch", "8"]
    outs = {}
    for name, n in (("ranks", DATA * POD), ("one", 1)):
        ckpt = tmp_path / name
        proc = _launch(n, *args, "--ckpt-dir", str(ckpt), timeout=300)
        assert proc.returncode == 0, (proc.stdout[-2000:]
                                      + proc.stderr[-3000:])
        assert proc.stdout.count("final loss") == 1
        outs[name] = ckpt
    for f in ("params.npz", "opt_state.npz"):
        a, b = np.load(outs["ranks"] / f), np.load(outs["one"] / f)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    cfg = get_config(ARCH, smoke=True)
    trainer = Trainer(cfg, DATA, pod_axis=POD, device="cpu", seq_len=8,
                      global_batch=8, sharding="fsdp", group_size=2, tau=5,
                      topology=Topology.hierarchical(
                          ("data", "pod"), (DATA, POD), dcn_axes=("pod",)))
    state = _load(trainer, str(outs["ranks"]))
    assert state.step == 50 and state.opt_state.count.tolist() == [50] * POD
    trainer.state = trainer._put_state(state)
    assert np.isfinite(trainer.step_once(50))


def test_cli_streamed_and_model_axis_fsdp_raise_naming_their_parts(
        monkeypatch):
    """Under torchrun ``--streamed`` is ported (slice 7c-2): it passes the
    launcher's checks and reaches the rank world's start, which it asks
    for the shard axis.  ``--sharding fsdp`` with ``--model-axis`` 2 is
    ported too (slice 7c-3): it asks the rank world's start for the model
    axis and the shard axis alike."""
    for k, v in dict(WORLD_SIZE="8", RANK="0", LOCAL_RANK="0",
                     LOCAL_WORLD_SIZE="8", REPRO_TORCH_DEVICE="cpu").items():
        monkeypatch.setenv(k, v)
    asked = {}

    class Reached(Exception):
        pass

    def init_rank_world(*args, **kw):
        asked.update(kw)
        raise Reached

    monkeypatch.setattr(train_mod.mesh, "init_rank_world", init_rank_world)
    argv = ["train", "--smoke", "--data-axis", "2", "--pod-axis", "2",
            "--sharding", "fsdp"]
    monkeypatch.setattr(sys, "argv", argv + ["--streamed"])
    assert "ported" in FSDP_STREAMED_SLICE
    with pytest.raises(Reached):
        train_mod.main()
    assert asked["shard_axis"] == "data" and asked["model"] == 1
    monkeypatch.setattr(sys, "argv", argv + ["--model-axis", "2"])
    assert "ported" in FSDP_MODEL_SLICE
    asked.clear()
    with pytest.raises(Reached):
        train_mod.main()
    assert asked["shard_axis"] == "data" and asked["model"] == 2
