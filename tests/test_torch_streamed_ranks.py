"""Layer-streamed FSDP within a pod over a rank world
(``ShardingPolicy.fsdp_within_pod("data", streamed=True)`` with
``world=``): each gloo rank is one member of its pod and holds its column
slice of the pod's grouped shard buckets; each span's all-gathers are
posted before the previous span computes and its reduce-scatters as soon
as its VJP ends.

Every rank check runs in one world of 8 gloo ranks on the CPU
(``rank_runs.streamed_ranks_worker``, smoke tinyllama-1.1b in float32,
each link class's budget pinned to ``BUDGET`` so that every span group
has several buckets):

* the plan over data 2 x pod 4 and over data 4 x pod 2 (pod size 4, where
  the order of the reduce-scatter's adds shows): every group's
  ``stream_unshard`` and ``stream_grad_shards`` ``torch.equal`` to the
  one-process streamed plan's on the pod's row;
* 6 steps of ``Trainer(world=..., sharding="fsdp", streamed=True)`` under
  ``wagma`` and ``allreduce`` from the JAX streamed ``Trainer``'s initial
  state: the gathered final state bit for bit the one-process streamed
  ``Trainer``'s and the gather-all ranks ``Trainer``'s (both merged to the
  canonical tree), the losses equal to the gather-all ranks' and within
  1e-5 of the JAX streamed ``Trainer`` on 8 host devices with Auto axes
  (ROADMAP.md F1); every fwd+bwd's event log held to the schedule
  (``streaming.check_stream_event_log``);
* one fwd+bwd with every receipt resolved as soon as it is posted equal
  to the asynchronous one, and one with span k's compute handed span
  k+1's gather (planted) parting from it;
* two steps in two microbatches, bit for bit the one-process run's;
* a poisoned member skips its whole pod, as on one process.

Then the launcher under torchrun (``--sharding fsdp --streamed
--ckpt-dir``) against the one-process launcher.
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
from repro_torch.core import bucketing, streaming
from repro_torch.core import tree as tr
from repro_torch.core.replica import (ShardingPolicy, effective_rank_map,
                                      pod_members)
from repro_torch.launch.train import Trainer

ARCH, DATA, POD, S, TAU, SEQ, GB, STEPS = ("tinyllama-1.1b", 2, 4, 2, 5, 16,
                                           16, 6)
BUDGET = 1 << 16         # bytes: every span group in several buckets
LOSS_RTOL = 1e-6         # the ranks against the one-process twin
JAX_RTOL = 1e-5          # against the JAX Trainer (test_torch_streaming.py)
BAD = 3                  # a member of pod 1 (ranks 2 and 3)
STREAM = ShardingPolicy.fsdp_within_pod("data", streamed=True)
FSDP = ShardingPolicy.fsdp_within_pod("data")
RUNS = {"wagma": dict(averager="wagma", group_size=S, tau=TAU),
        "allreduce": dict(averager="allreduce")}
LAYOUTS = {"2x4": (2, 4), "4x2": (4, 2)}       # (data, pod)

JAX_RUNS = """
    from jax.sharding import AxisType
    from repro.checkpoint import save_replica_state
    from repro.configs import get_config
    from repro.core import plan as plan_mod
    from repro.core.replica import ShardingPolicy
    from repro.launch.train import Trainer

    cfg = get_config({arch!r}, smoke=True).variant(dtype="float32")
    mesh = jax.make_mesh(({pod}, {data}, 1), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)
    topo = plan_mod.Topology(("data", "pod"), ({data}, {pod}), (
        plan_mod.LinkClass("ici", alpha=1e-6, beta=1e-11,
                           bucket_bytes={budget}),
        plan_mod.LinkClass("dcn", alpha=5e-5, beta=1e-10,
                           bucket_bytes={budget})), (0, 1))
    stream = ShardingPolicy.fsdp_within_pod("data", streamed=True)
    for name, kw in {runs!r}.items():
        tr = Trainer(cfg, mesh, seq_len={seq}, global_batch={gb}, seed=0,
                     topology=topo, sharding="fsdp", streamed=True, **kw)
        save_replica_state(f"{out}/{{name}}/init", jax.device_get(tr.state),
                           sharding=stream)
        with compat.set_mesh(mesh):
            losses = [tr.step_once(t) for t in range({steps})]
        np.save(f"{out}/{{name}}/losses.npy", np.asarray(losses))
    print("JAX_STREAMED_RUNS_DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("streamed_ranks"))
    res = run_sub(JAX_RUNS.format(arch=ARCH, runs=RUNS, seq=SEQ, gb=GB,
                                  steps=STEPS, out=out, data=DATA, pod=POD,
                                  budget=BUDGET),
                  devices=DATA * POD, timeout=900)
    assert "JAX_STREAMED_RUNS_DONE" in res
    ranks = rank_runs.spawn(
        "streamed_ranks", DATA * POD, os.path.join(out, "ranks"),
        timeout=600, data=DATA, pod=POD, shard_axis="data",
        inits={n: os.path.join(out, n, "init") for n in RUNS}, runs=RUNS,
        seq_len=SEQ, global_batch=GB, steps=STEPS, bad=BAD, budget=BUDGET)
    return out, ranks


def _trainer(name, streamed=True, microbatch=None):
    """The one-process FSDP Trainer of run ``name`` (no state yet)."""
    return Trainer(rank_runs.smoke_cfg(ARCH), DATA, pod_axis=POD,
                   device="cpu", seq_len=SEQ, global_batch=GB, seed=0,
                   sharding="fsdp", streamed=streamed,
                   topology=rank_runs.fsdp_topology("hier", (DATA, POD),
                                                    BUDGET),
                   microbatch=microbatch, **RUNS[name])


def _load(trainer, path):
    return load_replica_state(path, rank_runs.fsdp_state_template(
        trainer.cfg, trainer.plan()), sharding=trainer.sharding)


@pytest.fixture(scope="module")
def twins(runs):
    """Each run's one-process streamed Trainer from the JAX run's initial
    state after ``STEPS`` steps, and its losses."""
    out, _ = runs
    got = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in RUNS:
        trainer = _trainer(name)
        trainer.state = trainer._put_state(_load(trainer, os.path.join(
            out, name, "init")))
        got[name] = trainer, [trainer.step_once(t) for t in range(STEPS)]
    torch.set_num_threads(threads)
    return got


def _states_equal(a, b) -> bool:
    la = tr.tree_leaves((a.params, a.opt_state))
    lb = tr.tree_leaves((b.params, b.opt_state))
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _canonical(trainer, state):
    """A ``(P_eff, n_b)`` state's pod trees merged to the canonical tree:
    params and momentum leaves, the counts, step and phase."""
    plan = trainer.plan()

    def rows(buffers):
        tree = bucketing.unpack(tuple(buffers), plan.shard_layout,
                                cast=False)
        if plan.sharding.streamed:
            tree = trainer.model.layered.merge(tree, lead=1)
        return tr.tree_leaves(tree)
    return (rows(state.params), rows(state.opt_state.momentum),
            state.opt_state.count.tolist(), state.step, state.phase)


# ---------------------------------------------------------------------------
# The plan over ranks against the one-process plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lay", list(LAYOUTS))
def test_stream_unshard_and_grad_shards_equal_the_one_process_plan(runs,
                                                                   lay):
    """Each rank's gathered sub-tree of every group equals the one-process
    plan's views of its pod's row, and its reduce-scattered float32 slices
    of every group its column slice of the one-process
    ``stream_grad_shards`` of its pod's members' gradients."""
    _, ranks = runs
    data, _ = LAYOUTS[lay]
    plan = rank_runs.streamed_plan(LAYOUTS[lay], BUDGET)
    pods, grads = rank_runs.streamed_inputs(plan)
    treedef = tr.tree_flatten(plan.storage_struct)[1]
    shards = plan.shard_tree(tr.tree_unflatten(treedef, [
        torch.from_numpy(a) for a in pods]))
    groups = sorted(set(plan.shard_layout.bucket_groups))
    spans = [g for g in groups if 0 < g <= plan.n_stream_spans]
    assert all(len(plan.stream_bucket_indices(g)) > 1 for g in spans)
    eff = effective_rank_map(LAYOUTS[lay], 0)
    for r, res in enumerate(ranks):
        pod, coord = int(eff[r]), r % data
        for g in groups:
            want = tr.tree_leaves(plan.stream_unshard(shards, g, pod=pod))
            for i, leaf in enumerate(want):
                assert np.array_equal(res[f"{lay}/unshard/{g}/{i}"],
                                      leaf.numpy()), (r, g, i)
            members = (rank_runs.group_tree(plan, [
                torch.from_numpy(a[m]) for a in grads], g)
                for m in pod_members(plan, pod))
            for b, buf in enumerate(plan.stream_grad_shards(members, g)):
                n = buf.numel() // data
                assert np.array_equal(res[f"{lay}/grads/{g}/{b}"],
                                      buf[coord * n:(coord + 1) * n].numpy()
                                      ), (r, g, b)


# ---------------------------------------------------------------------------
# The Trainer over ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RUNS))
def test_streamed_rank_trainer_equals_one_process_and_gather_all(runs, twins,
                                                                 name):
    """Six steps over 8 ranks: the gathered checkpoint is the one-process
    streamed Trainer's final state bit for bit, and, merged to the
    canonical tree, the gather-all ranks Trainer's from the same initial
    state; every rank reports the gather-all ranks' losses and the
    one-process losses within 1e-6 relative; no update skipped."""
    out, ranks = runs
    twin, losses = twins[name]
    for r in ranks:
        assert np.array_equal(r[f"{name}/losses"],
                              r[f"{name}_gather_all/losses"])
        np.testing.assert_allclose(r[f"{name}/losses"], losses,
                                   rtol=LOSS_RTOL, atol=0)
        assert float(r[f"{name}/skipped"]) == 0
    got = _load(twin, os.path.join(out, "ranks", name))
    assert (got.step, got.phase) == (twin.state.step, twin.state.phase)
    assert _states_equal(got, twin.state)
    assert got.opt_state.count.tolist() == [STEPS] * POD
    gather_all = _trainer(name, streamed=False)
    assert (twin.plan().sharding, gather_all.plan().sharding) == (STREAM,
                                                                  FSDP)
    ga = _load(gather_all, os.path.join(out, "ranks", f"{name}_gather_all"))
    a, b = _canonical(twin, got), _canonical(gather_all, ga)
    assert a[2:] == b[2:]
    leaves = a[0] + a[1], b[0] + b[1]
    assert len(leaves[0]) == len(leaves[1])
    assert all(x.dtype == y.dtype and torch.equal(x, y)
               for x, y in zip(*leaves))


@pytest.mark.parametrize("name", list(RUNS))
def test_streamed_rank_trainer_matches_the_jax_streamed_trainer(runs, name):
    """The ranks' losses within 1e-5 of the JAX streamed ``Trainer``'s on
    8 host devices (Auto axes) from the same initial state."""
    out, ranks = runs
    want = np.load(os.path.join(out, name, "losses.npy"))
    np.testing.assert_allclose(ranks[0][f"{name}/losses"], want,
                               rtol=JAX_RTOL, atol=JAX_RTOL)


def test_every_streamed_step_follows_the_schedule_over_ranks(runs, twins):
    """On every rank every fwd+bwd's event log passed
    ``check_stream_event_log``: its bucket gathers those of
    ``expected_stream_gathers``, at most 2 span gathers live, 2 groups'
    reduce-scatters in flight at most (and at least once), its live
    gathered bytes at most the schedule's peak."""
    _, ranks = runs
    assert twins["wagma"][0].plan().shard_layout.n_buckets > 4
    for name in RUNS:
        plan = twins[name][0].plan()
        want = streaming.expected_stream_gathers(plan)
        for r in ranks:
            assert int(r[f"{name}/logs"]) == STEPS
            log = lambda k: r[f"{name}/log/{k}"].tolist()
            assert log("gathers") == [want] * STEPS
            assert max(log("span_gathers_live_max")) <= 2
            assert log("scatters_in_flight_max") == \
                [streaming.MAX_SCATTERS_IN_FLIGHT] * STEPS
            assert log("peak_gathered_bytes") == \
                [plan.stream_peak_gathered_bytes()] * STEPS
            assert log("peak_bound") == [plan.stream_peak_gathered_bytes()] \
                * STEPS


def test_check_stream_event_log_refuses_a_log_out_of_schedule(twins):
    """The one-process engine's log passes; a gather issued after the
    compute it should hide behind, a resolve after its consumer, a third
    group's scatter in flight, a gather missing or a peak above the
    schedule's each fail."""
    trainer = twins["wagma"][0]
    plan = trainer.plan()
    plan.stream_log = []
    batch = trainer._put_batch(0)
    b = GB // (DATA * POD)
    streaming.streamed_loss_and_grad_shards(
        plan, trainer.model.layered, trainer.state.params,
        [{k: v[m * b:(m + 1) * b] for k, v in batch.items()}
         for m in pod_members(plan, 0)], pod=0)
    record = plan.stream_log.pop()
    plan.stream_log = None
    streaming.check_stream_event_log(record, plan)
    ev = record["events"]
    first_span = streaming.span_group(0)
    issue = next(i for i, e in enumerate(ev)
                 if e[:2] == (streaming.GATHER_POST, first_span + 1))
    compute = next(i for i, e in enumerate(ev)
                   if e[:2] == (streaming.COMPUTE, first_span))
    late = ev[:issue] + ev[issue + 1:compute + 1] + [ev[issue]] \
        + ev[compute + 1:]
    resolve = next(i for i, e in enumerate(ev)
                   if e[:2] == (streaming.GATHER_RESOLVE, first_span))
    after = ev[:resolve] + ev[resolve + 1:compute + 1] + [ev[resolve]] \
        + ev[compute + 1:]
    lands = [i for i, e in enumerate(ev)
             if e[0] == streaming.SCATTER_RESOLVE]
    held = [e for i, e in enumerate(ev) if i != lands[0]] + [ev[lands[0]]]
    for bad, match in (({"events": late}, "issued after"),
                       ({"events": after}, "resolved out of order"),
                       ({"events": held}, "in flight"),
                       ({"gathers": record["gathers"] - 1}, "bucket gathers"),
                       ({"peak_gathered_bytes":
                         plan.stream_peak_gathered_bytes() + 1}, "live")):
        with pytest.raises(AssertionError, match=match):
            streaming.check_stream_event_log(dict(record, **bad), plan)


def test_serial_equals_async_and_mispaired_gathers_part(runs):
    """One fwd+bwd from the final state with every receipt resolved as
    soon as it is posted equals the asynchronous one (loss and slices) on
    every rank; handing span k's compute span k+1's gather (planted)
    parts from it on every rank."""
    _, ranks = runs
    for r in ranks:
        assert bool(r["pair/serial_equal"])
        assert bool(r["pair/mispaired_parts"])


def test_streamed_microbatches_over_ranks_equal_the_one_process_run(runs):
    """Two steps in two microbatches: each microbatch re-walks the engine
    and the pod means accumulate as on one process; the gathered state is
    the one-process streamed Trainer's bit for bit."""
    out, ranks = runs
    trainer = _trainer("wagma", microbatch=2)
    trainer.state = trainer._put_state(_load(trainer, os.path.join(
        out, "wagma", "init")))
    losses = [trainer.step_once(t) for t in range(2)]
    for r in ranks:
        np.testing.assert_allclose(r["microbatch/losses"], losses,
                                   rtol=LOSS_RTOL, atol=0)
    got = _load(trainer, os.path.join(out, "ranks", "microbatch"))
    assert _states_equal(got, trainer.state)
    assert got.opt_state.count.tolist() == [2] * POD


def test_a_poisoned_member_skips_its_whole_streamed_pod(runs):
    """A NaN in member BAD's mask rows: its pod alone skips (count 0 on
    both members), every other pod updates, and the gathered state equals
    the one-process streamed step's bit for bit."""
    out, ranks = runs
    trainer = _trainer("wagma")
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
    assert [int(r["guard/count"][0]) for r in ranks] == \
        [c for c in pod_counts for _ in range(DATA)]
    assert float(ranks[0]["guard/skipped"]) == DATA / (DATA * POD)


def test_consolidated_streamed_over_ranks_is_the_one_process_consensus(
        runs, twins):
    """``Trainer.consolidated()`` over ranks merges the gathered layered
    state to the canonical tree on rank 0: the one-process streamed
    Trainer's consensus model, bit for bit."""
    _, ranks = runs
    want = rank_runs.flat_tree(twins["wagma"][0].consolidated())
    got = {k[len("wagma/cons/"):]: v for k, v in ranks[0].items()
           if k.startswith("wagma/cons/")}
    assert set(got) == set(want) and not any(
        k.startswith("wagma/cons/") for k in ranks[1])
    for k, v in want.items():
        assert np.array_equal(got[k], v.float().numpy()), k


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_cli_streamed_fsdp_under_torchrun_checkpoints_as_one_process(
        tmp_path):
    """``--sharding fsdp --streamed --pod-dcn --ckpt-dir`` over 8 ranks
    (data 2 x pod 4) writes at step 50 the checkpoint the one-process
    launcher writes, byte for byte."""
    args = ["--arch", ARCH, "--smoke", "--data-axis", str(DATA),
            "--pod-axis", str(POD), "--pod-dcn", "--sharding", "fsdp",
            "--streamed", "--group-size", "2", "--tau", "5", "--steps",
            "50", "--seq-len", "8", "--global-batch", "8"]
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    outs = {}
    for name, n in (("ranks", DATA * POD), ("one", 1)):
        ckpt = tmp_path / name
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *args,
               "--ckpt-dir", str(ckpt)]
        if n > 1:
            cmd[1:3] = ["-m", "torch.distributed.run", "--standalone",
                        "--nproc-per-node", str(n), "-m",
                        "repro_torch.launch.train"]
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              timeout=300)
        assert proc.returncode == 0, (proc.stdout[-2000:]
                                      + proc.stderr[-3000:])
        assert proc.stdout.count("final loss") == 1
        outs[name] = ckpt
    for f in ("manifest.json", "params.npz", "opt_state.npz"):
        assert (outs["ranks"] / f).read_bytes() == \
            (outs["one"] / f).read_bytes(), f
