"""The port's averaging over ranks (``torch.distributed``, gloo on the CPU)
against its stacked realisation on the same numpy inputs.

Rank worlds of 2 and 4 (``data``) and of pod 2 x data 2 under
``Topology.hierarchical``: the group average over the wire is bit-identical
to the stacked plan's rows on every phase offset, per leaf, fused and fused
with the overlapped wavefront; ``sync`` and the wire's ``pmean`` are held
within 1e-6 relative (a bfloat16 leaf within one bfloat16 step: the float32
sums differ only in their order, and a last-bit difference can round the
cast the other way); each baseline's ``comm`` on every phase and its
``sync`` against its stacked self (the gossip mixes bit for bit, the
pmeans as ``sync``).  The wavefront over ranks is asynchronous: each
rank's event log issues bucket k+1's exchange before it resolves bucket
k's, within the schedule's count in flight; the asynchronous average is
the serial one's and the JAX plan's under ``shard_map`` bit for bit (data
4, S 2 and 4, one JAX subprocess beside the gloo worlds); a wavefront that
hands bucket k's combine bucket k+1's receipt parts from the stacked
plan.  The hierarchical plan's link classes, budgets, layouts and stage
runs match the JAX plan's.  Each world runs once per module
(``rank_runs.spawn``, a timeout of its own); the rank world's bookkeeping
and the backend rules are checked in process.
"""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import rank_runs
from subproc import SRC
from repro.core import plan as jplan
from repro.core.wagma import WagmaConfig as JConfig
from repro_torch.core import baselines
from repro_torch.core import overlap as to
from repro_torch.core import plan as tp
from repro_torch.core import tree as tr
from repro_torch.launch import mesh

SMALL = 1024          # bytes: several buckets, so K2 gets multi-pair batches
LEAVES = {"emb": (33, 7), "w": (130,), "s": (), "h": (3, 5), "e": (0, 4),
          "m": (40, 9), "v": (300,)}
BF16 = ("h",)
VARIANTS = {
    "per_leaf": dict(fused=False),
    "fused_serial": dict(bucket_bytes=SMALL, overlap=False),
    "fused_overlap": dict(bucket_bytes=SMALL),
}
# world -> (data, pod, hierarchical, group sizes)
WORLDS = {
    "data2": (2, None, False, (2,)),
    "data4": (4, None, False, (2, 4)),
    "pod2x2": (2, 2, True, (2, 4)),
}
GOSSIP = ("dpsgd", "sgp", "adpsgd")
OVERLAP = "fused_overlap"

# the JAX plan's fused overlapped average under shard_map on 4 host
# devices (the data4 world's inputs), every offset at S 2 and 4
JAX_AVERAGE = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P
    from repro import compat
    from repro.core import plan as plan_mod
    arrs = dict(np.load({inp!r}))
    tree = {{k: jnp.asarray(a, jnp.bfloat16 if k in {bf16!r} else
                           jnp.float32) for k, a in arrs.items()}}
    local = jax.tree.map(lambda a: a[0], tree)
    mesh = jax.make_mesh((4,), ("data",))
    out = {{}}
    for S in (2, 4):
        pl = plan_mod.compile_plan(
            plan_mod.Topology.flat(("data",), (4,)), local,
            plan_mod.AveragingConfig(group_size=S, bucket_bytes={small}))
        for off in pl.offsets:
            f = compat.shard_map(
                lambda t, pl=pl, off=off: pl.average_offset(t, off),
                mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                axis_names={{"data"}})
            for k, v in jax.jit(f)(tree).items():
                out[f"{{S}}/{{off}}/{{k}}"] = np.asarray(v, np.float32)
    np.savez({outp!r}, **out)
    print("JAX_AVERAGE_DONE")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world's ranks, and beside them the JAX plan's average of the
    data4 world's inputs (under ``"jax"``)."""
    d = tmp_path_factory.mktemp("jax_average")
    inp, outp = str(d / "in.npz"), str(d / "out.npz")
    np.savez(inp, **rank_runs.tree_inputs(LEAVES, BF16, 4))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_AVERAGE.format(
            src=SRC, inp=inp, outp=outp, bf16=BF16, small=SMALL))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    out = {}
    try:
        for name, (data, pod, hier, sizes) in WORLDS.items():
            n = data * (pod or 1)
            rows = rank_runs.spawn(
                "plan", n, str(tmp_path_factory.mktemp(name)), data=data,
                pod=pod, leaves=LEAVES, bf16=BF16, variants=VARIANTS,
                group_sizes=sizes, hierarchical=hier)
            out[name] = rows
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "JAX_AVERAGE_DONE" in stdout, \
        stderr[-3000:]
    out["jax"] = dict(np.load(outp))
    return out


def _topology(name):
    data, pod, hier, _ = WORLDS[name]
    names, sizes = mesh.dp_axes(data, pod)
    if hier:
        return tp.Topology.hierarchical(names, sizes)
    return tp.Topology.flat(names, sizes)


def _stacked_tree(name):
    data, pod, _, _ = WORLDS[name]
    P = data * (pod or 1)
    return rank_runs.torch_tree(rank_runs.tree_inputs(LEAVES, BF16, P),
                                BF16)


def _rows(rows, prefix):
    """The ranks' rows of the tree saved under ``prefix``, stacked."""
    return {k: np.concatenate([r[f"{prefix}/{k}"] for r in rows])
            for k in LEAVES}


def _as_np(tree):
    return {k: v.float().numpy() for k, v in tree.items()}


def _assert_equal(got, want, msg):
    for k in LEAVES:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{msg} {k}")


def _assert_mean_close(got, want, msg):
    """Float32 leaves within 1e-6 relative; a bfloat16 leaf within one
    bfloat16 step of its value."""
    for k in LEAVES:
        rtol = 2.0 ** -8 if k in BF16 else 1e-6
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7,
                                   err_msg=f"{msg} {k}")


CASES = [(w, S, v) for w, (_, _, _, sizes) in WORLDS.items() for S in sizes
         for v in VARIANTS]


@pytest.mark.parametrize("world,S,variant", CASES)
def test_group_average_over_ranks_is_bit_identical_to_stacked(
        runs, world, S, variant):
    tree = _stacked_tree(world)
    plan = tp.compile_plan(_topology(world), tr.struct(tree, drop=1),
                           tp.AveragingConfig(group_size=S,
                                              **VARIANTS[variant]))
    assert plan.offsets, plan.describe()
    for off in plan.offsets:
        _assert_equal(_rows(runs[world], f"avg/{S}/{variant}/{off}"),
                      _as_np(plan.average_offset(tree, off)),
                      f"{world} S={S} {variant} offset {off}")


def _overlap_plan(world, S):
    return tp.compile_plan(_topology(world),
                           tr.struct(_stacked_tree(world), drop=1),
                           tp.AveragingConfig(group_size=S,
                                              **VARIANTS[OVERLAP]))


@pytest.mark.parametrize("world,S", [(w, S) for w, (_, _, _, sizes)
                                     in WORLDS.items() for S in sizes])
def test_event_log_over_ranks_follows_the_wavefront(runs, world, S):
    """On every rank and offset the overlapped average's log follows
    ``pipeline_schedule`` over the plan's buckets and stage runs: each
    cell issued, resolved and combined in that order, bucket k+1's issue
    before bucket k's resolve, at least 2 and at most the schedule's
    count in flight; the wire's slots never exceed that count."""
    plan = _overlap_plan(world, S)
    bound = 0
    for off in plan.offsets:
        runs_ = plan.runs_for_offset(off)
        want = [(plan.class_layout(r.class_index).n_buckets, len(r.bits))
                for r in runs_]
        bound = max([bound] + [to.max_in_flight(*w) for w in want])
        for rank, r in enumerate(runs[world]):
            records = json.loads(str(r[f"events/{S}/{OVERLAP}/{off}"]))
            assert [(x["buckets"], x["stages"]) for x in records] == want
            for x in records:
                summary = to.check_event_log(x)
                pos = {(kind, k, s): i for i, (kind, k, s, _)
                       in enumerate(x["events"])}
                for k in range(x["buckets"] - 1):
                    for s in range(x["stages"]):
                        assert pos[(to.ISSUE, k + 1, s)] < \
                            pos[(to.RESOLVE, k, s)], (rank, off, k, s)
                assert 2 <= summary["in_flight_max"] <= summary["bound"]
    for r in runs[world]:
        assert 2 <= int(r[f"slots/{S}"]) <= bound


@pytest.mark.parametrize("S", [2, 4])
def test_async_average_over_ranks_is_serial_and_jax_bit_for_bit(runs, S):
    """Over 4 ranks the asynchronous wavefront gives the serial path's
    average and the JAX plan's (``shard_map`` on 4 host devices, the same
    inputs) bit for bit on every offset."""
    plan = _overlap_plan("data4", S)
    for off in plan.offsets:
        got = _rows(runs["data4"], f"avg/{S}/{OVERLAP}/{off}")
        _assert_equal(got, _rows(runs["data4"],
                                 f"avg/{S}/fused_serial/{off}"),
                      f"S={S} offset {off} async vs serial")
        _assert_equal(got, {k: runs["jax"][f"{S}/{off}/{k}"]
                            for k in LEAVES},
                      f"S={S} offset {off} async vs the JAX plan")


@pytest.mark.parametrize("world,S", [(w, S) for w, (_, _, _, sizes)
                                     in WORLDS.items() for S in sizes])
def test_mispaired_receipts_part_from_stacked(runs, world, S):
    """A wavefront that hands bucket k's combine bucket k+1's receipt must
    fail the stacked-plan equality: some rank's rows part on some
    offset."""
    plan = _overlap_plan(world, S)
    tree = _stacked_tree(world)
    parted = []
    for off in plan.offsets:
        want = _as_np(plan.average_offset(tree, off))
        got = _rows(runs[world], f"fault/{S}/{OVERLAP}/{off}")
        parted.append(any(not np.array_equal(got[k], want[k])
                          for k in LEAVES))
    assert any(parted), parted


@pytest.mark.parametrize("world,S,variant", CASES)
def test_sync_over_ranks_matches_stacked_mean(runs, world, S, variant):
    tree = _stacked_tree(world)
    plan = tp.compile_plan(_topology(world), tr.struct(tree, drop=1),
                           tp.AveragingConfig(group_size=S,
                                              **VARIANTS[variant]))
    want = _as_np(plan.sync({k: v.clone() for k, v in tree.items()}))
    got = _rows(runs[world], f"sync/{S}/{variant}")
    _assert_mean_close(got, want, f"{world} S={S} {variant}")
    for k in LEAVES:        # and every rank holds the same mean
        for r in range(1, got[k].shape[0]):
            np.testing.assert_array_equal(got[k][r], got[k][0])


@pytest.mark.parametrize("world", list(WORLDS))
def test_wire_pmean_matches_stacked(runs, world):
    w = _stacked_tree(world)["w"].float()
    got = np.concatenate([r["pmean"] for r in runs[world]])
    np.testing.assert_allclose(got, tp.pmean_rows(w).numpy(), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("world,name", [(w, n) for w in WORLDS
                                        for n in baselines.BASELINES])
def test_baseline_over_ranks_matches_stacked(runs, world, name):
    tree = _stacked_tree(world)
    topo = _topology(world)
    av = baselines.make_averager(name, topo.axis_names, topo.axis_sizes,
                                 topology=topo)
    check = _assert_equal if name in GOSSIP else _assert_mean_close
    for phase in range(av.n_phases):
        check(_rows(runs[world], f"{name}/comm/{phase}"),
              _as_np(av.comm(tree, phase)), f"{world} {name} comm {phase}")
    _assert_mean_close(_rows(runs[world], f"{name}/sync"),
                       _as_np(av.sync({k: v.clone() for k, v in
                                       tree.items()})),
                       f"{world} {name} sync")


# ---------------------------------------------------------------------------
# The hierarchical plan against the JAX plan's (compile only)
# ---------------------------------------------------------------------------

# leaves of 4-64 MiB: ICI's cheap launches and DCN's dear ones pick
# different budgets
BIG = {"a": (4096, 4096), "b": (1024, 1024), "c": (2048, 512), "d": (3000,),
       "e": (512, 2048), "f": (8192, 1024)}


@pytest.mark.parametrize("S", [2, 4, 8])
def test_hierarchical_plan_matches_jax(S):
    names, sizes = ("data", "pod"), (4, 2)
    pt = {k: tr.Spec(s, torch.float32) for k, s in BIG.items()}
    jt = {k: jax.ShapeDtypeStruct(s, np.float32) for k, s in BIG.items()}
    ours = tp.compile_plan(tp.Topology.hierarchical(names, sizes), pt,
                           tp.AveragingConfig(group_size=S))
    ref = jplan.compile_plan(jplan.Topology.hierarchical(names, sizes), jt,
                             JConfig(group_size=S))
    assert ours.topology.axis_class == ref.topology.axis_class == (0, 1)
    assert [l.name for l in ours.topology.link_classes] == \
        [l.name for l in ref.topology.link_classes] == ["ici", "dcn"]
    for a, b in zip(ours.topology.link_classes, ref.topology.link_classes):
        assert (a.alpha, a.beta, a.gamma) == (b.alpha, b.beta, b.gamma)
    assert ours.class_bucket_bytes == ref.class_bucket_bytes
    assert len(set(ours.class_bucket_bytes.values())) == 2
    for ci in ours.topology.classes_in_use():
        assert ours.class_layout(ci).bucket_sizes == \
            ref.class_layout(ci).bucket_sizes
    assert ours.offsets == ref.offsets
    for off in ours.offsets:
        assert [(r.class_index, r.bits) for r in ours.runs_for_offset(off)] \
            == [(r.class_index, r.bits) for r in ref.runs_for_offset(off)]
        assert [{k: v for k, v in r.items() if k != "exchanges"}
                for r in ours.butterfly_summary(off)] == \
            [{k: v for k, v in r.items() if k != "ppermutes"}
             for r in ref.butterfly_summary(off)]
    assert ours.sync_bucket_bytes == ref.sync_bucket_bytes


def test_hierarchical_without_a_dcn_axis_is_flat_ici():
    t = tp.Topology.hierarchical(("data",), (8,))
    assert t == tp.Topology.flat(("data",), (8,), link=tp.ICI)


# ---------------------------------------------------------------------------
# The rank world's bookkeeping and the backend rules
# ---------------------------------------------------------------------------

def _world(rank, data=2, pod=2, backend="gloo", device="cpu"):
    names, sizes = mesh.dp_axes(data, pod)
    return mesh.RankWorld(names, sizes, rank, torch.device(device), backend)


def test_rank_world_coords_follow_dp_axis_layout():
    # global dp rank = pod * data_size + data, minor axis first
    for r in range(4):
        w = _world(r)
        assert w.coords == (r % 2, r // 2)
        assert w.rank_of(w.coords) == r
    assert _world(3).P == 4


def test_butterfly_partner_and_ring_neighbours(monkeypatch):
    sent = []

    def fake_exchange(self, buf, send_to, recv_from):
        sent.append((send_to, recv_from))
        return buf

    monkeypatch.setattr(tp.RankWire, "_exchange", fake_exchange)
    buf = torch.zeros(1, 4)
    for r in range(8):
        wire = tp.RankWire(_world(r, data=4, pod=2))
        sent.clear()
        for bit in range(3):
            wire.butterfly_exchange(buf, bit)
        assert sent == [(r ^ (1 << b), r ^ (1 << b)) for b in range(3)]
        sent.clear()
        wire.ring_shift(buf, 1, 4)
        wire.ring_shift(buf, -1, 4)
        base = r - r % 4
        ahead, behind = base + (r + 1) % 4, base + (r - 1) % 4
        assert sent == [(ahead, behind), (behind, ahead)]


def test_nccl_hands_device_buffers_to_the_wire(monkeypatch):
    """The nccl branch gives the collectives the buffers themselves (no
    host staging); gloo stages only a card's buffers."""
    handed = []

    class Done:
        def wait(self):
            pass

    def fake_batch(ops):
        for op in ops:
            handed.append(op.tensor)
        return [Done()]

    def fake_collective(out, t, async_op=False, **kw):
        handed.append(t)
        return Done()

    monkeypatch.setattr(tp.dist, "batch_isend_irecv", fake_batch)
    monkeypatch.setattr(tp.dist, "all_to_all_single", fake_collective)
    monkeypatch.setattr(tp.dist, "all_gather_into_tensor", fake_collective)
    monkeypatch.setattr(tp.dist, "P2POp",
                        lambda fn, t, peer: type("Op", (), {"tensor": t}))
    wire = tp.RankWire(_world(1, backend="nccl"))
    buf = torch.arange(8.0)[None]
    wire.butterfly_exchange(buf, 0)
    assert handed[0].data_ptr() == buf.data_ptr()
    assert handed[1].shape == buf.shape
    handed.clear()
    wire.sync_rows_(buf)
    assert handed[0].data_ptr() == buf.data_ptr()
    assert not _world(0, backend="nccl", device="cuda").stages_through_host
    assert _world(0, backend="gloo", device="cuda").stages_through_host
    assert not _world(0, backend="gloo", device="cpu").stages_through_host


def test_backend_is_explicit_and_nccl_needs_a_card_per_local_rank(
        monkeypatch):
    assert mesh.resolve_backend(None, "cpu") == "gloo"
    assert mesh.resolve_backend(None, "cuda") == "nccl"
    assert mesh.resolve_backend("gloo", "cuda") == "gloo"
    with pytest.raises(ValueError, match="nccl"):
        mesh.resolve_backend("nccl", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        mesh.resolve_backend("mpi", "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="one card per local rank"):
        mesh.rank_device("nccl", "cuda", 1, 4)
    # gloo: every local rank shares the one card
    assert {mesh.rank_device("gloo", "cuda", r, 4) for r in range(4)} == \
        {torch.device("cuda", 0)}
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.rank_device("gloo", "cuda", 0, 4)


def test_init_rank_world_refuses_axes_that_do_not_tile_the_world(
        monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="the world has 4 ranks"):
        mesh.init_rank_world(2, device_type="cpu")


def test_plan_refuses_a_world_of_other_axes():
    names, sizes = mesh.dp_axes(4)
    with pytest.raises(ValueError, match="do not match"):
        tp.compile_plan(tp.Topology.flat(names, sizes),
                        {"w": tr.Spec((3,), torch.float32)},
                        world=_world(0, data=2, pod=2))


def test_ranks_that_start_together_build_the_kernels_once(tmp_path,
                                                          monkeypatch):
    """The first process to take the build directory's file lock compiles;
    the others wait for it and find the library built."""
    import threading
    import time

    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib_path",
                        lambda name: tmp_path / f"lib{name}.so")
    compiled = []

    def fake_compile(todo):
        if todo:
            compiled.append(list(todo))
            time.sleep(0.2)
            for name in todo:
                (tmp_path / f"lib{name}.so").write_text("built")
        return {}

    monkeypatch.setattr(_build, "_compile", fake_compile)
    threads = [threading.Thread(target=_build.build, args=(["k1", "k3"],))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert compiled == [["k1", "k3"]]
    assert (tmp_path / "build.lock").exists()
