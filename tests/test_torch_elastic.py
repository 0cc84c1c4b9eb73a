"""The port's elastic membership (``repro_torch/core/elastic.py``,
``launch/elastic.py``, ``core/plan.evict_topology``): the host-side cases
of tests/test_elastic.py against the port, the membership controller held
to the JAX package's on seeded and hypothesis interleavings, row
selection on the replica rows, ``ElasticTrainer``'s refusals and its regrow
guard, and both demo scenarios held to the JAX ``ElasticTrainer``.

The differential scenarios run the JAX ``ElasticTrainer`` once, in one
subprocess on forced host devices (its ``mesh_over`` builds Auto-typed
meshes), on qwen3-0.6b's smoke config in float32: ``chaos_demo``'s
schedule over a pool of 8 and ``kill_rejoin_demo``'s script over a pool
of 4.  Each run's initial state crosses into the port's ``init_state=``;
event logs, records, staleness snapshots, epoch logs and fingerprints
must be equal, losses, params and moments within ``RTOL`` (the JAX
Trainer tests' tolerance), and the rows bit-identical at the last
tau-sync in both packages."""

import json

import jax
import numpy as np
import pytest
import torch

from jax_trainer_runs import jax_state, nest
from subproc import run_sub

from repro.core import elastic as jax_elastic
from repro.core import plan as jax_plan
from repro_torch.configs import get_config
from repro_torch.core import bucketing
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.core.elastic import (MembershipController, MembershipEvent,
                                      diff_topology, handoff_state,
                                      largest_pow2, regrow_replica_state,
                                      resize_topology, select_replica_rows)
from repro_torch.core.plan import AveragingConfig, Topology, compile_plan
from repro_torch.core.replica import FSDP_SLICE, ReplicaState
from repro_torch.launch import elastic as el
from repro_torch.launch.elastic import (CHAOS_SCHEDULE, ElasticTrainer,
                                        check_chaos, check_kill_rejoin,
                                        kill_rejoin_events)
from repro_torch.launch.mesh import RankWorld
from repro_torch.models.convert import replica_state_from_jax
from repro_torch.optim.sgd import SGDState

TREE = {"emb": tr.Spec((33, 70), torch.float32),
        "w": tr.Spec((1300,), torch.float32),
        "h": tr.Spec((300,), torch.bfloat16)}
ARCH = "qwen3-0.6b"
RTOL = 1e-5
# the differential runs: tau, group size, lr and seed of the reference's
# demos; a shorter sequence than the Trainer's default 512 keeps the JAX
# subprocess short (the schedule, not the model, decides the membership)
RUN_KW = dict(tau=4, group_size=2, seed=0, learning_rate=0.05, seq_len=64)
CHAOS_POOL, CHAOS_STEPS = 8, 12
KILL_POOL, KILL_STEPS, KILL_LEAVE = 4, 8, 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: under the suite's parallel workers more intra-op
    threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# Quantisation + topology diffing
# ---------------------------------------------------------------------------

def test_largest_pow2():
    assert [largest_pow2(n) for n in (0, 1, 2, 3, 4, 5, 7, 8, 9)] == \
        [0, 1, 2, 2, 4, 4, 4, 8, 8]
    assert largest_pow2(-3) == 0
    assert largest_pow2(1 << 20) == 1 << 20


def test_diff_topology_resize_only():
    old = Topology.hierarchical(("data", "pod"), (4, 2))
    new = resize_topology(old, "data", 2)
    d = diff_topology(old, new)
    assert d.requires_recompile
    assert d.resized == (("data", 4, 2),)
    assert "data: 4 -> 2" in d.describe()
    assert d.describe() == jax_elastic.diff_topology(
        jax_plan.Topology.hierarchical(("data", "pod"), (4, 2)),
        jax_plan.Topology.hierarchical(("data", "pod"), (2, 2))).describe()
    same = diff_topology(old, old)
    assert not same.requires_recompile
    assert same.describe() == "topology unchanged"


def test_diff_topology_rejects_structural_changes():
    old = Topology.hierarchical(("data", "pod"), (4, 2))
    renamed = Topology.hierarchical(("data", "node"), (4, 2))
    with pytest.raises(ValueError, match="axis names"):
        diff_topology(old, renamed)
    flat = Topology.flat(("data", "pod"), (4, 2))
    with pytest.raises(ValueError, match="link-class"):
        diff_topology(old, flat)


def test_resize_topology_validation():
    topo = Topology.hierarchical(("data", "pod"), (4, 2))
    assert resize_topology(topo, "pod", 4).axis_sizes == (4, 4)
    with pytest.raises(ValueError, match="no axis"):
        resize_topology(topo, "nope", 2)
    with pytest.raises(ValueError):
        resize_topology(topo, "data", 3)


def test_drop_axis_matches_the_jax_package():
    mine = Topology.hierarchical(("data", "pod"), (4, 2)).drop_axis("data")
    theirs = jax_plan.Topology.hierarchical(("data", "pod"),
                                            (4, 2)).drop_axis("data")
    assert (mine.axis_names, mine.axis_sizes, mine.axis_class) == \
        (theirs.axis_names, theirs.axis_sizes, theirs.axis_class) == \
        (("pod",), (2,), (1,))
    assert [l.name for l in mine.link_classes] == \
        [l.name for l in theirs.link_classes]
    with pytest.raises(ValueError, match="not in"):
        mine.drop_axis("data")
    with pytest.raises(ValueError, match="only dp axis"):
        mine.drop_axis("pod")


# ---------------------------------------------------------------------------
# MembershipController state machine
# ---------------------------------------------------------------------------

def test_controller_quantizes_shrinks_and_regrows():
    c = MembershipController(range(6))
    m = c.membership
    assert m.active == (0, 1, 2, 3) and m.spares == (4, 5)
    assert m.epoch == 0 and m.world_size == 4
    ev = c.leave(1)
    assert ev.kind == "shrink" and ev.epoch == 1
    assert ev.world == (0, 2) and ev.keep_rows == (0, 2)
    assert c.membership.spares == (4, 5, 3)
    assert c.leave(4).kind == "noop"
    assert c.membership.spares == (5, 3)
    assert c.join(1).kind == "defer"
    assert c.join(1).kind == "noop"
    assert c.membership.pending == (1,)
    ev = c.at_sync_barrier()
    assert ev.kind == "regrow" and ev.epoch == 2 and ev.n_joined == 2
    assert ev.world == (0, 2, 5, 3)
    assert c.membership.pending == (1,)
    assert c.at_sync_barrier().kind == "noop"
    assert [m.epoch for m in c.history] == [0, 1, 2]
    assert c.history[1].active == (0, 2)


def test_controller_min_world_floor():
    with pytest.raises(ValueError, match="at least"):
        MembershipController([0], min_world=2)
    c = MembershipController([0, 1])
    with pytest.raises(RuntimeError, match="survivors"):
        c.leave(0)
    with pytest.raises(ValueError, match="unknown worker"):
        c.leave(9)
    with pytest.raises(ValueError, match="duplicate"):
        MembershipController([0, 0, 1])


# ---------------------------------------------------------------------------
# Checkpoint-free state handoff
# ---------------------------------------------------------------------------

def _stacked_state(n_rows: int, seed: int = 0) -> ReplicaState:
    rng = np.random.default_rng(seed)
    params = {"w": torch.from_numpy(rng.normal(size=(n_rows, 5))).float(),
              "b": torch.from_numpy(rng.normal(size=(n_rows, 3))).to(
                  torch.bfloat16)}
    mom = tr.tree_map(lambda p: 0.5 * p.float(), params)
    return ReplicaState(params, SGDState(
        mom, torch.arange(n_rows, dtype=torch.int32)), step=7, phase=1)


def _leaves(state):
    return tr.tree_leaves((state.params, state.opt_state))


def test_select_replica_rows_and_regrow():
    st = _stacked_state(4)
    rows = [2, 0]
    sel = select_replica_rows(st, rows)
    for got, src in zip(_leaves(sel), _leaves(st)):
        assert got.dtype == src.dtype and torch.equal(got, src[rows])
    assert (sel.step, sel.phase) == (7, 1)
    assert sel.opt_state.count.tolist() == [2, 0]
    grown = regrow_replica_state(sel, 4, source_row=0)
    w = grown.params["w"]
    assert w.shape[0] == 4
    assert torch.equal(w[2], w[0]) and torch.equal(w[3], w[0])
    assert grown.opt_state.count.tolist() == [2, 0, 2, 2]
    with pytest.raises(ValueError, match="regrow"):
        regrow_replica_state(grown, 2)


def test_select_replica_rows_returns_new_tensors():
    """The selection copies: the old world's rows can be freed at once,
    and writing the new rows leaves the old ones as they were."""
    st = _stacked_state(4)
    sel = select_replica_rows(st, [0, 1, 2, 3])
    for got, src in zip(_leaves(sel), _leaves(st)):
        assert got.data_ptr() != src.data_ptr()
    before = st.params["w"].clone()
    sel.params["w"].add_(1.0)
    assert torch.equal(st.params["w"], before)


def test_handoff_replicated_is_row_selection():
    st = _stacked_state(4)
    a = handoff_state(st, [1, 3])
    b = select_replica_rows(st, [1, 3])
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


def test_handoff_of_a_sharded_state_raises_and_names_slice_7():
    """tests/test_elastic.py's FSDP pod shrink, ported: pods 0 and 3 of
    (data 2, pod 4) survive into (data 2, pod 2), unpacked through the old
    plan's shard layout, selected and repacked through the new plan's, bit
    for bit (tests/test_torch_fsdp.py holds it to the JAX package).  A
    handoff across policies raises, and pod-granular membership in
    ``ElasticTrainer`` is queued with slice 7c (its refusal below).  The
    same shrink of the layer-streamed state re-seats it through its
    grouped layouts; streamed <-> gather-all raises."""
    from repro_torch.core.replica import (ShardingPolicy, _unpack_rows,
                                          replicated_to_fsdp_state)
    st = _stacked_state(8)
    fsdp = ShardingPolicy.fsdp_within_pod("data")
    struct = tr.struct(st.params, drop=1)
    plans = [compile_plan(Topology.hierarchical(("data", "pod"), (2, pods)),
                          struct, AveragingConfig(group_size=2), fsdp)
             for pods in (4, 2)]
    old = replicated_to_fsdp_state(st, plans[0])
    new = handoff_state(old, [0, 3], old_plan=plans[0], new_plan=plans[1])
    assert new.opt_state.count.tolist() == [0, 6]
    for got, want in ((new.params, old.params),
                      (new.opt_state.momentum, old.opt_state.momentum)):
        g_rows = _unpack_rows(got, plans[1].shard_layout, cast=False)
        w_rows = _unpack_rows(want, plans[0].shard_layout, cast=False)
        for g, w in zip(tr.tree_leaves(g_rows), tr.tree_leaves(w_rows)):
            assert torch.equal(g, w[[0, 3]])
    for kw in (dict(old_plan=plans[0]), dict(new_plan=plans[1])):
        with pytest.raises(ValueError, match="sharding policies"):
            handoff_state(old, [0, 1], **kw)
    layered = {"stem": {"s": struct["w"]}, "layers": (struct, struct),
               "head": {"h": struct["w"]}}
    streamed = ShardingPolicy.fsdp_within_pod("data", streamed=True)
    splans = [compile_plan(Topology.hierarchical(("data", "pod"), (2, pods)),
                           layered, AveragingConfig(group_size=2), streamed)
              for pods in (4, 2)]
    assert splans[0].shard_layout.grouped
    rows = tr.tree_map(lambda a: a, st.params)
    lay_state = ReplicaState(
        {"stem": {"s": rows["w"]}, "layers": (rows, rows),
         "head": {"h": rows["w"]}},
        st.opt_state._replace(momentum={
            "stem": {"s": st.opt_state.momentum["w"]},
            "layers": (st.opt_state.momentum, st.opt_state.momentum),
            "head": {"h": st.opt_state.momentum["w"]}}), st.step, st.phase)
    sold = replicated_to_fsdp_state(lay_state, splans[0])
    snew = handoff_state(sold, [0, 3], old_plan=splans[0],
                         new_plan=splans[1])
    g_rows = _unpack_rows(snew.params, splans[1].shard_layout)
    w_rows = _unpack_rows(sold.params, splans[0].shard_layout)
    for g, w in zip(tr.tree_leaves(g_rows), tr.tree_leaves(w_rows)):
        assert torch.equal(g, w[[0, 3]])
    with pytest.raises(ValueError, match="streamed <-> gather-all"):
        handoff_state(sold, [0, 3], old_plan=splans[0], new_plan=plans[1])
    assert "slice 7c" in FSDP_SLICE


# ---------------------------------------------------------------------------
# Plan-cache hygiene on membership change
# ---------------------------------------------------------------------------

def test_evict_topology_drops_only_the_dead_world():
    topo_a = Topology.hierarchical(("data", "pod"), (4, 2))
    topo_b = resize_topology(topo_a, "data", 2)
    cfg = AveragingConfig(group_size=2, bucket_bytes=4096)
    pa = compile_plan(topo_a, TREE, cfg)
    pa2 = compile_plan(topo_a, TREE, AveragingConfig(group_size=4,
                                                     bucket_bytes=4096))
    pb = compile_plan(topo_b, TREE, cfg)
    assert compile_plan(topo_a, TREE, cfg) is pa
    assert plan_mod.evict_topology(topo_a) == 2
    assert compile_plan(topo_a, TREE, cfg) is not pa
    assert compile_plan(topo_a, TREE, AveragingConfig(
        group_size=4, bucket_bytes=4096)) is not pa2
    assert compile_plan(topo_b, TREE, cfg) is pb
    assert plan_mod.evict_topology(topo_a) == 2
    assert plan_mod.evict_topology(topo_a) == 0


def test_evict_topology_releases_a_rank_worlds_wire():
    """A rank world's wire (and its pinned host buffers) goes with the last
    plan over that world; a wire another topology's plan runs on stays."""
    world = RankWorld(("data",), (4,), 0, torch.device("cpu"), "gloo")
    topo = Topology.flat(("data",), (4,))
    other = Topology.flat(("data",), (4,), link=plan_mod.ICI)
    cfg = AveragingConfig(group_size=2)
    plan = compile_plan(topo, TREE, cfg, world=world)
    assert plan_mod._WIRES[world] is plan.wire
    compile_plan(other, TREE, cfg, world=world)
    assert plan_mod.evict_topology(topo) == 1
    assert plan_mod._WIRES[world] is plan.wire
    assert plan_mod.evict_topology(other) == 1
    assert world not in plan_mod._WIRES


def test_core_exports_the_jax_packages_names():
    import repro.core
    import repro_torch.core
    assert sorted(repro_torch.core.__all__) == sorted(repro.core.__all__)
    assert all(hasattr(repro_torch.core, n) for n in repro_torch.core.__all__)


def test_clear_plan_cache_delegates_to_layout_cache():
    bucketing.layout_for(TREE, max_bucket_bytes=4096)
    assert bucketing._LAYOUT_CACHE
    plan_mod.clear_plan_cache()
    assert not bucketing._LAYOUT_CACHE
    assert not plan_mod._PLAN_CACHE


# ---------------------------------------------------------------------------
# ElasticTrainer on the port
# ---------------------------------------------------------------------------

def _cfg(dtype=None):
    cfg = get_config(ARCH, smoke=True)
    return cfg if dtype is None else cfg.variant(dtype=dtype)


@pytest.mark.parametrize("kw,match", [
    (dict(averager="allreduce"), "tau-sync barrier"),
    (dict(sharding="fsdp"), "not in the reference"),
    (dict(world=RankWorld(("data",), (4,), 0, torch.device("cpu"),
                          "gloo")), "rank world"),
])
def test_elastic_trainer_refusals(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        ElasticTrainer(_cfg(), 4, device="cpu", **kw)


def test_kill_rejoin_training_survives_and_rejoiner_bit_identical():
    """A worker dies at t=2 and announces its rejoin: the world shrinks
    4 -> 2, training continues, the t=3 tau-sync regrows it, and at the
    final tau-sync the rejoiner's row is bit-identical to every
    survivor's (``kill_rejoin_demo``'s acceptance, on the CPU)."""
    et = ElasticTrainer(_cfg(), KILL_POOL, device="cpu", **dict(
        RUN_KW, seq_len=16))
    records = et.run(KILL_STEPS, events=kill_rejoin_events(KILL_LEAVE, 2))
    rep = check_kill_rejoin(et, records, steps=KILL_STEPS,
                            leave_step=KILL_LEAVE)
    assert rep["rejoin_bit_identical"]
    assert [r["world"] for r in records] == [4, 4, 2, 2, 4, 4, 4, 4]
    assert [r["epoch"] for r in records] == [0, 0, 1, 1, 2, 2, 2, 2]
    assert all(e["plans_evicted"] == 1 for e in rep["epoch_log"])


def test_run_takes_a_step_probe():
    """``run``'s ``step`` runs each step in place of ``step_once``: the
    same losses, and the probe sees every step's trainer."""
    kw = dict(RUN_KW, seq_len=16)
    plain = ElasticTrainer(_cfg(), 4, device="cpu", **kw).run(3)
    seen = []

    def probe(trainer, t):
        seen.append((t, trainer.n_dp))
        return trainer.step_once(t)

    probed = ElasticTrainer(_cfg(), 4, device="cpu", **kw).run(3, step=probe)
    assert seen == [(0, 4), (1, 4), (2, 4)]
    assert [r["loss"] for r in probed] == [r["loss"] for r in plain]


def test_regrow_outside_the_barrier_raises():
    """The consensus guard: seating joiners on rows that are not the
    post-sync consensus (here after a group step) must raise."""
    et = ElasticTrainer(_cfg(), 4, device="cpu", **dict(RUN_KW, seq_len=16))
    et.run(1)
    assert not el._rows_identical(et.trainer.state.params)
    with pytest.raises(AssertionError, match="outside the tau-sync"):
        et._transition(MembershipEvent("regrow", 1, (0, 1, 2, 3)))


def test_transition_frees_the_old_worlds_state():
    """After a shrink nothing ``ElasticTrainer`` holds refers to the old
    world's rows; they are garbage before the new world's first step."""
    import weakref
    et = ElasticTrainer(_cfg(), 4, device="cpu", **dict(RUN_KW, seq_len=16))
    et.run(1)
    old = weakref.ref(et.trainer.state.params["emb"])
    et.leave(3)
    assert old() is None
    assert tr.tree_leaves(et.trainer.state.params)[0].shape[0] == 2


def test_state_digest_is_bit_sensitive():
    st = _stacked_state(4)
    a = el.state_digest(st)
    assert a == el.state_digest(select_replica_rows(st, range(4)))
    st.params["w"].view(torch.int32)[3, 4] ^= 1
    assert el.state_digest(st) != a
    st.params["w"].view(torch.int32)[3, 4] ^= 1
    assert el.state_digest(st) == a
    st.step += 1
    assert el.state_digest(st) != a


# ---------------------------------------------------------------------------
# The controller against the JAX package's on the same interleavings
# ---------------------------------------------------------------------------

_OPS = ("leave", "join", "barrier")


def _drive(mc, ops):
    """Replay an interleaving; one outcome per op (the event's fields and
    the membership, or the error type)."""
    out = []
    for op, w in ops:
        try:
            ev = (mc.leave(w) if op == "leave" else mc.join(w)
                  if op == "join" else mc.at_sync_barrier())
        except (ValueError, RuntimeError) as e:
            out.append(("error", type(e).__name__))
            continue
        m = mc.membership
        out.append((ev.kind, ev.epoch, ev.world, ev.keep_rows, ev.n_joined,
                    m.epoch, m.active, m.spares, m.pending))
    return out


def _check_invariants(ops, pool):
    """tests/test_elastic.py's invariants after every op, on the port."""
    mc = MembershipController(range(pool), min_world=2)
    last_epoch = mc.epoch
    for op, w in ops:
        before = mc.membership
        try:
            if op == "leave":
                ev = mc.leave(w)
            elif op == "join":
                ev = mc.join(w)
                assert ev.kind in ("defer", "noop")
                assert mc.membership.active == before.active
            else:
                ev = mc.at_sync_barrier()
        except (ValueError, RuntimeError):
            assert mc.membership == before
            continue
        m = mc.membership
        n = m.world_size
        assert n >= mc.min_world and n & (n - 1) == 0, m
        seen = list(m.active) + list(m.spares) + list(m.pending)
        assert len(seen) == len(set(seen)), m
        if ev.kind == "shrink":
            assert [before.active[i] for i in ev.keep_rows] == list(m.active)
        if set(m.active) != set(before.active):
            assert mc.epoch == last_epoch + 1
            assert ev.kind in ("shrink", "regrow"), ev
        else:
            assert mc.epoch == last_epoch
        last_epoch = mc.epoch
    assert [h.epoch for h in mc.history] == list(range(mc.epoch + 1))


def _same_as_jax(ops, pool):
    _check_invariants(ops, pool)
    got = _drive(MembershipController(range(pool)), ops)
    want = _drive(jax_elastic.MembershipController(range(pool)), ops)
    assert got == want


from hypothesis_compat import given, settings, st  # noqa: E402


@given(ops=st.lists(st.tuples(st.sampled_from(_OPS), st.integers(0, 13)),
                    max_size=50),
       pool=st.integers(4, 12))
@settings(max_examples=80, deadline=None)
def test_membership_matches_jax_property(ops, pool):
    _same_as_jax(ops, pool)


@pytest.mark.parametrize("seed", range(6))
def test_membership_matches_jax_seeded_interleavings(seed):
    rng = np.random.default_rng(seed)
    pool = int(rng.integers(4, 13))
    ops = [(_OPS[int(rng.integers(3))], int(rng.integers(14)))
           for _ in range(60)]
    _same_as_jax(ops, pool)


# ---------------------------------------------------------------------------
# Both demo scenarios against the JAX ElasticTrainer
# ---------------------------------------------------------------------------

JAX_SCRIPT = """
    import json
    from repro.configs import get_config
    from repro.core import faults
    from repro.core.faults import FaultSchedule
    from repro.launch.elastic import ElasticTrainer, _rows_identical

    def flat(prefix, tree):
        return {{prefix + "/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(v) for path, v in
                jax.tree_util.tree_leaves_with_path(tree)}}

    def save(name, tag, state):
        out.update(flat(f"{{name}}/params{{tag}}/", state.params))
        out.update(flat(f"{{name}}/momentum{{tag}}/",
                        state.opt_state.momentum))
        out[f"{{name}}/count{{tag}}"] = np.asarray(state.opt_state.count)
        out[f"{{name}}/step_phase{{tag}}"] = np.asarray(
            [int(state.step), int(state.phase)])

    def finish(name, et, log):
        host = jax.device_get(et.trainer.state)
        save(name, 1, host)
        log.update(epoch_log=et.epoch_log,
                   rows_identical=bool(_rows_identical(host.params)))
        out[f"{{name}}/log"] = np.asarray(json.dumps(log))

    out = {{}}
    cfg = get_config({arch!r}, smoke=True).variant(dtype="float32")
    kw = {kw!r}
    et = ElasticTrainer(cfg, jax.devices()[:{chaos_pool}], **kw)
    save("chaos", 0, jax.device_get(et.trainer.state))
    sched = FaultSchedule.of(faults.hang(1, 2, recover_after=3),
                             faults.crash(3, 8, rejoin_after=3))
    rep = et.run_under_faults({chaos_steps}, sched)
    finish("chaos", et, {{k: rep[k] for k in (
        "records", "events", "staleness", "schedule_fingerprint")}})

    et = ElasticTrainer(cfg, jax.devices()[:{kill_pool}], **kw)
    save("kill", 0, jax.device_get(et.trainer.state))
    records = et.run({kill_steps}, events={{{kill_leave}: [("leave", 2),
                                                          ("join", 2)]}})
    finish("kill", et, {{"records": records}})
    np.savez({outp!r}, **out)
    print("JAX_ELASTIC_DONE")
"""


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    outp = str(tmp_path_factory.mktemp("jax_elastic") / "runs.npz")
    out = run_sub(JAX_SCRIPT.format(
        arch=ARCH, kw=RUN_KW, chaos_pool=CHAOS_POOL,
        chaos_steps=CHAOS_STEPS, kill_pool=KILL_POOL, kill_steps=KILL_STEPS,
        kill_leave=KILL_LEAVE, outp=outp), devices=8, timeout=900)
    assert "JAX_ELASTIC_DONE" in out
    return dict(np.load(outp))


def _port_run(res, name, pool):
    """The port's ElasticTrainer seated on the JAX run's initial state,
    from an empty plan cache as the JAX subprocess starts (each epoch's
    evicted plans are compared)."""
    plan_mod.clear_plan_cache()
    cfg = _cfg("float32")
    state = replica_state_from_jax(cfg, jax_state(res, name, 0, pool), "cpu")
    assert state.opt_state.count.tolist() == \
        res[f"{name}/count0"].tolist()
    return cfg, ElasticTrainer(cfg, pool, device="cpu", init_state=state,
                               **RUN_KW)


def _plain(x):
    """JSON's view of a log (integer dict keys become strings), so that
    both packages' logs compare as the same text."""
    return json.loads(json.dumps(x))


def _check_against_jax(res, name, cfg, et, records, pool):
    want = json.loads(str(res[f"{name}/log"]))
    fields = [k for k in want["records"][0] if k != "loss"]
    assert [{k: r[k] for k in fields} for r in records] == \
        [{k: r[k] for k in fields} for r in want["records"]]
    np.testing.assert_allclose([r["loss"] for r in records],
                               [r["loss"] for r in want["records"]],
                               rtol=RTOL, atol=RTOL)
    assert _plain(et.epoch_log) == want["epoch_log"]
    assert el._rows_identical(et.trainer.state.params)
    assert want["rows_identical"]
    st = et.trainer.state
    assert st.opt_state.count.tolist() == res[f"{name}/count1"].tolist()
    assert [st.step, st.phase] == res[f"{name}/step_phase1"].tolist()
    assert et.trainer.skipped_nonfinite == 0
    final = replica_state_from_jax(cfg, jax_state(res, name, 1, pool),
                                   "cpu")
    for tag in ("params", "momentum"):
        got = st.params if tag == "params" else st.opt_state.momentum
        exp = final.params if tag == "params" else final.opt_state.momentum
        for g, w in zip(tr.tree_leaves(got), tr.tree_leaves(exp)):
            scale = float(w.abs().max()) or 1.0
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                       atol=RTOL * scale, err_msg=tag)
    return want


def test_chaos_demo_schedule_matches_the_jax_elastic_trainer(jax_runs):
    cfg, et = _port_run(jax_runs, "chaos", CHAOS_POOL)
    rep = et.run_under_faults(CHAOS_STEPS, CHAOS_SCHEDULE)
    check_chaos(et, rep, steps=CHAOS_STEPS)
    want = _check_against_jax(jax_runs, "chaos", cfg, et, rep["records"],
                              CHAOS_POOL)
    assert _plain(rep["events"]) == want["events"]
    assert _plain(rep["staleness"]) == want["staleness"]
    assert rep["schedule_fingerprint"] == want["schedule_fingerprint"]
    assert [r["world"] for r in rep["records"]] == \
        [8] * 4 + [4] * 4 + [8] * 2 + [4] * 2
    assert rep["staleness"]["peak_age"] == RUN_KW["tau"]


def test_kill_rejoin_script_matches_the_jax_elastic_trainer(jax_runs):
    cfg, et = _port_run(jax_runs, "kill", KILL_POOL)
    records = et.run(KILL_STEPS, events=kill_rejoin_events(KILL_LEAVE, 2))
    check_kill_rejoin(et, records, steps=KILL_STEPS, leave_step=KILL_LEAVE)
    _check_against_jax(jax_runs, "kill", cfg, et, records, KILL_POOL)
    assert [r["world"] for r in records] == [4, 4, 2, 2, 4, 4, 4, 4]


def test_jax_initial_state_crosses_into_the_port(jax_runs):
    """``init_state=`` seats the first world on the JAX run's rows as
    they are: both packages start the scenarios from the same weights."""
    for name, pool in (("chaos", CHAOS_POOL), ("kill", KILL_POOL)):
        _, et = _port_run(jax_runs, name, pool)
        got = tr.tree_leaves(et.trainer.state.params)
        want = jax.tree.leaves(nest(jax_runs, f"{name}/params0/"))
        assert len(got) == len(want) and got[0].shape[0] == pool
        assert sum(g.numel() for g in got) == sum(w.size for w in want)
        assert {(g.dtype, g.shape[0]) for g in got} == \
            {(torch.float32, pool)}
