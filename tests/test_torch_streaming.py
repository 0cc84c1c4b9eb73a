"""The port's layer-streamed FSDP engine (``core/streaming.py``,
``ShardingPolicy.fsdp_within_pod(axis, streamed=True)``) against the JAX
package's, at smoke size.

Host-side, in this process, exact: the grouped (layer-aware) layouts and
``describe_groups``; ``layered_leaf_groups``, the streamed plan's shard
layout, its per-group sublayouts and byte accounting for tinyllama-1.1b
(its real tree and its smoke one), qwen3-0.6b and gemma3-12b (a span of 2
local and 1 global layer); the schedule and its invariants; the layered
split and merge; streamed checkpoints written by either package and
restored across streamed <-> gather-all <-> replicated by the other;
``serving_weights_from_checkpoint`` of a streamed manifest; the streamed
``handoff_state``.  In the port itself: the streamed Trainer equals the
gather-all one bit for bit on the CPU (losses, params, momentum), with two
microbatches and with the chunked head at vocab 65536.

On 8 forced host devices with Auto axes (ROADMAP.md F1), in one
subprocess: the JAX streamed plan's ``average`` on every offset, flat and
hierarchical, which the port's must equal bit for bit; and five steps of
the JAX streamed ``Trainer`` (qwen3-0.6b, tied, and tinyllama-1.1b in
float32), which the port's must follow to the FSDP tests' tolerance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subproc import run_sub

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_config
from repro.core import bucketing as jbucketing
from repro.core import elastic as jelastic
from repro.core import plan as jplan_mod
from repro.core import replica as jreplica
from repro.core import streaming as jstreaming
from repro.models.registry import build_model as jax_build
from repro.optim.sgd import SGDState as JSGDState
from repro.serve import handoff as jhandoff
from repro_torch.checkpoint import load_replica_state, save_replica_state
from repro_torch.configs import get_config
from repro_torch.core import bucketing, elastic, replica, streaming
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.core.replica import ReplicaState, ShardingPolicy
from repro_torch.launch.train import Trainer
from repro_torch.models.registry import build_model
from repro_torch.optim.sgd import SGDState
from repro_torch.serve.handoff import (serving_weights_from_checkpoint,
                                       serving_weights_from_state)

DATA, POD, S, TAU, SEQ, GB, STEPS = 2, 4, 2, 5, 16, 16, 5
# the Trainer runs' tolerance, as tests/test_torch_fsdp.py holds the FSDP
# Trainer: matmul and reduction orders differ between the backends
RTOL = 1e-5
STREAM = ShardingPolicy.fsdp_within_pod("data", streamed=True)
FSDP = ShardingPolicy.fsdp_within_pod("data")
JSTREAM = jreplica.ShardingPolicy.fsdp_within_pod("data", streamed=True)
JFSDP = jreplica.ShardingPolicy.fsdp_within_pod("data")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the JAX package's grouped test tree (tests/test_streaming.py): dict
# order head < layers < stem, group order stem < spans < head
GROUPED = {"stem": {"emb": ((33, 70), "float32")},
           "layers": ({"w": ((1300,), "float32"), "h": ((300,), "bfloat16")},
                      {"w": ((1300,), "float32"), "h": ((300,), "bfloat16")}),
           "head": {"out": ((40,), "float32"), "e": ((0, 4), "float32")}}
# an oversize span: one layer past the 4096-byte budget
OVERSIZE = {"stem": {"s": ((8,), "float32")},
            "layers": ({"a": ((3000,), "float32"), "b": ((900,), "float32"),
                        "c": ((900,), "float32")},
                       {"t": ((8,), "float32")}),
            "head": {"h": ((8,), "float32")}}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree[0], tuple):
        return tuple(_map(v, fn) for v in tree)
    return fn(*tree)


def _ttree(tree):
    return _map(tree, lambda s, d: tr.Spec(tuple(s), TORCH_DT[d]))


def _jtree(tree):
    return _map(tree, lambda s, d: jax.ShapeDtypeStruct(tuple(s),
                                                        jnp.dtype(d)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bits_equal(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _dt_name(d) -> str:
    return str(d).split(".")[-1]


def _assert_same_layout(lay, jlay):
    assert lay.bucket_sizes == jlay.bucket_sizes
    assert [_dt_name(d) for d in lay.bucket_dtypes] == \
        [np.dtype(d).name for d in jlay.bucket_dtypes]
    assert lay.bucket_groups == jlay.bucket_groups
    assert [(s.bucket, s.offset, s.size, s.shape) for s in lay.slots] == \
        [(s.bucket, s.offset, s.size, s.shape) for s in jlay.slots]
    assert lay.describe_groups() == jlay.describe_groups()
    assert lay.describe() == jlay.describe()


# ---------------------------------------------------------------------------
# Grouped layouts and the schedule (host side, exact)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tree", ["grouped", "oversize"])
@pytest.mark.parametrize("align", [1, 2])
def test_grouped_layouts_match_jax(tree, align):
    """Bucket for bucket (sizes, dtypes, groups, slots, the empty leaf,
    the oversize span split into buckets of its own) and the layer map:
    ``group_bucket_map``, ``group_bytes``, ``describe_groups``; the layout
    cache keys on the groups; pack/unpack round-trips."""
    spec = GROUPED if tree == "grouped" else OVERSIZE
    t, j = _ttree(spec), _jtree(spec)
    groups = streaming.layered_leaf_groups(t)
    assert groups == jstreaming.layered_leaf_groups(j)
    lay = bucketing.build_layout(t, max_bucket_bytes=4096, align=align,
                                 groups=groups)
    jlay = jbucketing.build_layout(j, max_bucket_bytes=4096, align=align,
                                   groups=groups)
    _assert_same_layout(lay, jlay)
    assert lay.grouped and list(lay.bucket_groups) == \
        sorted(lay.bucket_groups)
    assert lay.group_bucket_map() == jlay.group_bucket_map()
    assert [lay.group_bytes(g) for g in lay.group_bucket_map()] == \
        [jlay.group_bytes(g) for g in jlay.group_bucket_map()]
    if tree == "oversize":
        assert len(lay.group_bucket_map()[1]) >= 2
    plain = bucketing.layout_for(t, max_bucket_bytes=4096, align=align)
    cached = bucketing.layout_for(t, max_bucket_bytes=4096, align=align,
                                  groups=groups)
    assert not plain.grouped and plain.describe_groups() == "ungrouped"
    assert cached is bucketing.layout_for(
        t, max_bucket_bytes=4096, align=align, groups=groups)
    rng = np.random.default_rng(0)
    conc = tr.tree_map(lambda s: torch.from_numpy(
        rng.normal(size=s.shape).astype(np.float32)).to(s.dtype), t)
    back = bucketing.unpack(bucketing.pack(conc, lay), lay)
    for a, b in zip(tr.tree_leaves(conc), tr.tree_leaves(back)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="layered param tree"):
        streaming.layered_leaf_groups({"a": t["stem"]})


@pytest.mark.parametrize("n_spans", [0, 1, 2, 3, 6, 13, 22])
def test_stream_schedule_matches_jax(n_spans):
    events = streaming.stream_schedule(n_spans)
    assert events == jstreaming.stream_schedule(n_spans)
    streaming.validate_stream_schedule(events, n_spans)
    rng = np.random.default_rng(n_spans)
    gb = {g: int(rng.integers(1, 1000)) for g in range(n_spans + 2)}
    assert streaming.max_in_flight_gathered_bytes(gb, n_spans) == \
        jstreaming.max_in_flight_gathered_bytes(gb, n_spans)
    if n_spans > 1:
        bad = list(events)
        i = bad.index(("compute", 1))
        j = bad.index(("gather", 2))
        bad[i], bad[j] = bad[j], bad[i]    # span 1's prefetch after span 0
        with pytest.raises(AssertionError):
            streaming.validate_stream_schedule(bad, n_spans)


MODELS = [("tinyllama-1.1b", False), ("tinyllama-1.1b", True),
          ("qwen3-0.6b", True), ("gemma3-12b", True)]


def _plans(arch, smoke, topo="hier", sizes=(DATA, POD), budget=None):
    """(port, JAX) streamed plans over the model's layered tree and the
    two models."""
    cfg = get_config(arch, smoke=smoke)
    model = build_model(cfg, device="cpu")
    jm = jax_build(jax_config(arch, smoke=smoke))
    from repro_torch.models.convert import PARAM_SPECS
    t = model.layered.split(PARAM_SPECS[cfg.family](cfg))
    j = jax.eval_shape(jm.layered.split, jax.eval_shape(
        jm.init, jax.random.PRNGKey(0)))
    links = (plan_mod.LinkClass("ici", alpha=1e-6, beta=1e-11,
                                bucket_bytes=budget),
             plan_mod.LinkClass("dcn", alpha=5e-5, beta=1e-10,
                                bucket_bytes=budget))
    cls = (0, 0) if topo == "flat" else (0, 1)
    links = links[:1] if topo == "flat" else links
    tt = plan_mod.Topology(("data", "pod"), sizes, links, cls)
    jt = jplan_mod.Topology(("data", "pod"), sizes, tuple(
        jplan_mod.LinkClass(l.name, l.alpha, l.beta, l.gamma, l.bucket_bytes)
        for l in links), cls)
    tp = plan_mod.compile_plan(tt, t, plan_mod.AveragingConfig(
        group_size=S), STREAM)
    jp = jplan_mod.compile_plan(jt, j, jplan_mod.AveragingConfig(
        group_size=S), JSTREAM)
    return tp, jp, model, jm


@pytest.mark.parametrize("arch,smoke", MODELS)
def test_streamed_plan_layout_and_accounting_match_jax(arch, smoke):
    """The layered leaf groups, the grouped shard layout, every group's
    sublayout (equal to the global slice), the byte accounting, the
    gathers a member's fwd+bwd reads and the plan's layer-map lines."""
    tp, jp, model, jm = _plans(arch, smoke)
    assert tp.n_stream_spans == jp.n_stream_spans == model.layered.n_spans
    assert tp._stream_groups == jp._stream_groups
    _assert_same_layout(tp.shard_layout, jp.shard_layout)
    for g in range(tp.n_stream_spans + 2):
        assert tp.stream_bucket_indices(g) == jp.stream_bucket_indices(g)
        _assert_same_layout(tp.stream_sublayout(g), jp.stream_sublayout(g))
    assert tp.stream_group_bytes() == jp.stream_group_bytes()
    assert tp.stream_peak_gathered_bytes() == jp.stream_peak_gathered_bytes()
    assert tp.full_gathered_bytes() == jp.full_gathered_bytes()
    assert streaming.expected_stream_gathers(tp) == \
        jstreaming.expected_stream_gathers(jp)
    assert tp.stream_peak_gathered_bytes() < tp.full_gathered_bytes()
    lines = lambda d: [l for l in d.splitlines() if "layer map" in l
                       or "streamed coverage" in l]
    assert lines(tp.describe()) == lines(jp.describe())
    if (arch, smoke) == ("tinyllama-1.1b", False):
        # 22 spans of one layer: the stem, 22 span buckets, the head
        lay = tp.shard_layout
        assert tp.n_stream_spans == 22
        assert [len(lay.group_bucket_indices(g)) for g in range(24)] == \
            [1] * 24
        assert lay.bucket_sizes[0] == 65536000
        assert lay.bucket_sizes[1:23] == (44044288,) * 22
        assert lay.bucket_sizes[23] == 65538048
        assert streaming.expected_stream_gathers(tp) == 46
    with pytest.raises(ValueError, match="streamed plan"):
        plan_mod.compile_plan(tp.topology, tp.storage_struct, tp.cfg,
                              FSDP).stream_sublayout(0)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-12b"])
def test_split_and_merge_layered_match_jax(arch):
    """``split_layered`` of a seeded tree equals the JAX package's leaf for
    leaf (gemma3's span holds 2 local and 1 global layer), ``merge``
    inverts it, and both carry leading replica dims (``lead=``) and
    ``Spec`` leaves."""
    cfg = get_config(arch, smoke=True).variant(dtype="float32")
    model = build_model(cfg, device="cpu")
    jm = jax_build(jax_config(arch, smoke=True).variant(dtype="float32"))
    params = model.init(torch.Generator().manual_seed(0))
    jparams = jax.tree.map(lambda a: jnp.asarray(a.numpy()),
                           params)
    lay = model.layered.split(params)
    jlay = jm.layered.split(jparams)
    assert len(lay["layers"]) == len(jlay["layers"]) == \
        model.layered.n_spans
    got = tr.tree_leaves(lay)
    want = jax.tree.leaves(jlay)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _bits_equal(g, w)
    back = model.layered.merge(lay)
    for a, b in zip(tr.tree_leaves(back), tr.tree_leaves(params)):
        assert torch.equal(a, b)
    stacked = tr.tree_map(lambda a: torch.stack([a, a + 1]), params)
    rows = model.layered.split(stacked, lead=1)
    for r in range(2):
        one = model.layered.split(tr.tree_map(lambda a: a[r], stacked))
        for a, b in zip(tr.tree_leaves(rows), tr.tree_leaves(one)):
            assert torch.equal(a[r], b)
    for a, b in zip(tr.tree_leaves(model.layered.merge(rows, lead=1)),
                    tr.tree_leaves(stacked)):
        assert torch.equal(a, b)
    specs = tr.struct(stacked)
    assert tr.struct(rows) == model.layered.split(specs, lead=1)
    assert model.layered.merge(model.layered.split(specs, lead=1),
                               lead=1) == specs


def test_streamed_policy_and_refusals():
    """``streamed=True`` is a policy of its own (a plan distinct from the
    gather-all one); it needs FSDP, a layered tree and a dense model.
    Over a rank world it builds (slice 7c-2, ported: its averager and its
    plan, whose butterfly runs on the world's pod view), and over a world
    with a model axis too (slice 7c-3), its pod view at this rank's model
    coordinate."""
    from repro_torch.core.baselines import make_averager
    from repro_torch.core.replica import (FSDP_MODEL_SLICE,
                                          FSDP_STREAMED_SLICE)
    from repro_torch.launch.mesh import RankWorld
    from repro_torch.launch.train import resolve_sharding
    from repro_torch.train.train_step import plan_of
    assert STREAM.describe() == JSTREAM.describe()
    assert resolve_sharding("fsdp_streamed", ("data", "pod")) == STREAM
    assert resolve_sharding("fsdp", ("data", "pod"), streamed=True) == STREAM
    with pytest.raises(ValueError, match="requires fsdp_within_pod"):
        ShardingPolicy("replicated", None, True)
    tp, _, _, _ = _plans("tinyllama-1.1b", True)
    with pytest.raises(ValueError, match="layered param tree"):
        plan_mod.compile_plan(tp.topology, _ttree(GROUPED)["layers"][0],
                              tp.cfg, STREAM)
    gather_all = plan_mod.compile_plan(
        tp.topology, build_model(get_config("tinyllama-1.1b", smoke=True),
                                 device="cpu").layered.merge(
            tp.storage_struct), tp.cfg, FSDP)
    assert gather_all is not tp and not gather_all.shard_layout.grouped
    cfg = get_config("recurrentgemma-2b", smoke=True)
    avg = make_averager("wagma", ("data", "pod"), (DATA, POD),
                        group_size=S, topology=tp.topology, sharding=STREAM)
    with pytest.raises(ValueError, match="per-layer apply"):
        plan_of(build_model(cfg, device="cpu"), avg)
    world = RankWorld(("data", "pod"), (2, 2), 0, torch.device("cpu"), "gloo")
    t = plan_mod.Topology.hierarchical(("data", "pod"), (2, 2))
    assert "7c-2" in FSDP_STREAMED_SLICE and "ported" in FSDP_STREAMED_SLICE
    ranked = make_averager("wagma", ("data", "pod"), (2, 2), topology=t,
                           sharding=STREAM, world=world)
    rank_plan = ranked.plan_for(tr.tree_map(
        lambda s: tr.Spec((1,) + tuple(s.shape), s.dtype),
        _ttree(GROUPED)))
    assert rank_plan.world is world and rank_plan.sharding == STREAM
    assert rank_plan.shard_layout.grouped and rank_plan.P_eff == 2
    assert rank_plan.wire.world.torch_ranks == (0, 2)
    assert rank_plan.n_stream_spans == 2
    model_world = RankWorld(("data", "pod"), (2, 2), 0, torch.device("cpu"),
                            "gloo", model=2, model_rank=1)
    assert "7c-3" in FSDP_MODEL_SLICE and "ported" in FSDP_MODEL_SLICE
    model_plan = make_averager(
        "wagma", ("data", "pod"), (2, 2), topology=t, sharding=STREAM,
        world=model_world).plan_for(tr.tree_map(
            lambda s: tr.Spec((1,) + tuple(s.shape), s.dtype),
            _ttree(GROUPED)))
    assert model_plan.world is model_world and model_plan.sharding == STREAM
    # pod to pod at data 0 and model 1: torch ranks 0 * 2 + 1, 2 * 2 + 1
    assert model_plan.wire.world.torch_ranks == (1, 5)


# ---------------------------------------------------------------------------
# Checkpoints, handoff and templates (host side)
# ---------------------------------------------------------------------------

def _model_states(arch="qwen3-0.6b", sizes=(DATA, POD), seed=0):
    """A replicated (P, ...) state whose pod members hold one model each,
    as both packages' ReplicaStates, and both streamed plans."""
    tp, jp, model, jm = _plans(arch, True, sizes=sizes)
    eff = replica.effective_rank_map(sizes, 0)
    gen = torch.Generator().manual_seed(seed)
    pods = [model.init(gen) for _ in range(tp.P_eff)]
    moms = [tr.tree_map(lambda a: torch.randn(a.shape, generator=gen), p)
            for p in pods]
    stack = lambda ts: tr.tree_map(lambda *xs: torch.stack(xs),
                                   *[ts[e] for e in eff])
    params, mom = stack(pods), stack(moms)
    count = torch.from_numpy((3 * eff + 1).astype(np.int32))
    ts = ReplicaState(params, SGDState(mom, count), 7, 1)
    to_j = lambda t: jax.tree.map(
        lambda a: jnp.asarray(a.float().numpy()).astype(
            jnp.bfloat16 if a.dtype == torch.bfloat16 else jnp.float32), t)
    js = jreplica.ReplicaState.create(
        to_j(params), JSGDState(to_j(mom), jnp.asarray(count.numpy())),
        step=7, phase=1)
    return tp, jp, model, jm, ts, js


def _assert_states_equal(got, want):
    g_leaves = tr.tree_leaves((got.params, got.opt_state))
    w_leaves = jax.tree.leaves((want.params, want.opt_state))
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == tuple(np.shape(w))
        assert _bits_equal(g, w)
    assert (int(got.step), int(got.phase)) == (int(want.step),
                                               int(want.phase))


def _streamed_states():
    tp, jp, model, jm, ts, js = _model_states()
    t_st = replica.replicated_to_fsdp_state(
        replica.split_layered_state(ts, model.layered), tp)
    j_st = jreplica.replicated_to_fsdp_state(
        jreplica.split_layered_state(js, jm.layered), jp)
    return tp, jp, model, jm, ts, js, t_st, j_st


def test_streamed_conversions_and_templates_match_jax():
    """replicated -> layered -> streamed and back, bit for bit in both
    packages and between them; the templates of a streamed plan and the
    canonical template of its layered one."""
    tp, jp, model, jm, ts, js, t_st, j_st = _streamed_states()
    _assert_states_equal(t_st, j_st)
    back = replica.merge_layered_state(
        replica.fsdp_to_replicated_state(t_st, tp), model.layered)
    _assert_states_equal(back, js)
    for tpl, jtpl in (
            (replica.sharded_state_template(tp, ts.opt_state),
             jreplica.sharded_state_template(jp, js.opt_state)),
            (replica.canonical_replicated_template(
                replica.replicated_state_template(tp, t_st.opt_state),
                model.layered),
             jreplica.canonical_replicated_template(
                 jreplica.replicated_state_template(jp, j_st.opt_state),
                 jm.layered))):
        got = tr.tree_leaves((tpl.params, tpl.opt_state))
        want = jax.tree.leaves((jtpl.params, jtpl.opt_state))
        assert [(tuple(s.shape), _dt_name(s.dtype)) for s in got] == \
            [(tuple(s.shape), np.dtype(s.dtype).name) for s in want]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_streamed_checkpoints_cross_packages_and_policies(direction,
                                                          tmp_path):
    """A streamed checkpoint written by either package restores in the
    other as streamed, as gather-all FSDP and as canonical replicated, and
    gather-all and replicated checkpoints restore as streamed: each equal
    to the writer's own conversion, bit for bit."""
    tp, jp, model, jm, ts, js, t_st, j_st = _streamed_states()
    ga = plan_mod.compile_plan(tp.topology, model.layered.merge(
        tp.storage_struct), tp.cfg, FSDP)
    jga = jplan_mod.compile_plan(jp.topology, jax.eval_shape(
        jm.layered.merge, jp.storage_struct), jp.cfg, JFSDP)
    t_ga = replica.replicated_to_fsdp_state(ts, ga)
    j_ga = jreplica.replicated_to_fsdp_state(js, jga)
    _assert_states_equal(t_ga, j_ga)
    paths = {k: str(tmp_path / k) for k in ("st", "ga", "rep")}
    t_tpl = replica.sharded_state_template(tp, ts.opt_state)
    ga_tpl = replica.sharded_state_template(ga, ts.opt_state)
    j_tpl = jreplica.sharded_state_template(jp, js.opt_state)
    jga_tpl = jreplica.sharded_state_template(jga, js.opt_state)
    if direction == "jax_to_port":
        jckpt.save_replica_state(paths["st"], j_st, sharding=JSTREAM)
        jckpt.save_replica_state(paths["ga"], j_ga, sharding=JFSDP)
        jckpt.save_replica_state(paths["rep"], js)
        L = model.layered
        _assert_states_equal(load_replica_state(
            paths["st"], t_tpl, sharding=STREAM), j_st)
        _assert_states_equal(load_replica_state(
            paths["st"], ga_tpl, sharding=FSDP, plan=ga, layered=L), j_ga)
        _assert_states_equal(load_replica_state(
            paths["st"], ts, plan=tp, layered=L), js)
        _assert_states_equal(load_replica_state(
            paths["ga"], t_tpl, sharding=STREAM, plan=tp, layered=L), j_st)
        _assert_states_equal(load_replica_state(
            paths["rep"], t_tpl, sharding=STREAM, plan=tp, layered=L), j_st)
        with pytest.raises(ValueError, match="layered"):
            load_replica_state(paths["st"], ts, plan=tp)
        with pytest.raises(ValueError, match="pass the compiled plan"):
            load_replica_state(paths["st"], ga_tpl, sharding=FSDP)
    else:
        save_replica_state(paths["st"], t_st, sharding=STREAM)
        save_replica_state(paths["ga"], t_ga, sharding=FSDP)
        save_replica_state(paths["rep"], ts)
        L = jm.layered
        assert jckpt.checkpoint_sharding(paths["st"]) == JSTREAM
        _assert_states_equal(t_st, jckpt.load_replica_state(
            paths["st"], j_tpl, sharding=JSTREAM))
        _assert_states_equal(t_ga, jckpt.load_replica_state(
            paths["st"], jga_tpl, sharding=JFSDP, plan=jga, layered=L))
        _assert_states_equal(ts, jckpt.load_replica_state(
            paths["st"], js, plan=jp, layered=L))
        _assert_states_equal(t_st, jckpt.load_replica_state(
            paths["ga"], j_tpl, sharding=JSTREAM, plan=jp, layered=L))
        _assert_states_equal(t_st, jckpt.load_replica_state(
            paths["rep"], j_tpl, sharding=JSTREAM, plan=jp, layered=L))


def test_serving_weights_of_a_streamed_state_and_checkpoint(tmp_path):
    """A JAX-written streamed checkpoint hands off, through the port's
    streamed plan and model, the weights the JAX package hands off; from
    the state they equal the gather-all state's, bit for bit; without
    ``model=`` the layered tree cannot be merged."""
    tp, jp, model, jm, ts, js, t_st, j_st = _streamed_states()
    path = str(tmp_path / "st")
    jckpt.save_replica_state(path, j_st, sharding=JSTREAM)
    got = serving_weights_from_checkpoint(
        path, replica.sharded_state_template(tp, ts.opt_state), plan=tp,
        model=model)
    want = jhandoff.serving_weights_from_checkpoint(
        path, jreplica.sharded_state_template(jp, js.opt_state), plan=jp,
        model=jm)
    for g, w in zip(tr.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-6)
    direct = serving_weights_from_state(t_st, plan=tp, model=model)
    ga = plan_mod.compile_plan(tp.topology, model.layered.merge(
        tp.storage_struct), tp.cfg, FSDP)
    gathered = serving_weights_from_state(
        replica.replicated_to_fsdp_state(ts, ga), plan=ga)
    for a, b, c in zip(tr.tree_leaves(direct), tr.tree_leaves(got),
                       tr.tree_leaves(gathered)):
        assert torch.equal(a, b) and _bits_equal(a, c)
    with pytest.raises(ValueError, match="model="):
        serving_weights_from_state(t_st, plan=tp)


def test_handoff_state_streamed_shrink_matches_jax():
    """Pods 1 and 3 of 4 survive into (data 2, pod 2) under the streamed
    policy, as the JAX package re-seats them; streamed <-> gather-all
    raises in both."""
    tp, jp, model, jm, ts, js, t_st, j_st = _streamed_states()
    tn, jn, _, _ = _plans("qwen3-0.6b", True, sizes=(DATA, 2), budget=16384)
    got = elastic.handoff_state(t_st, [1, 3], old_plan=tp, new_plan=tn)
    want = jelastic.handoff_state(j_st, [1, 3], old_plan=jp, new_plan=jn)
    _assert_states_equal(got, want)
    ga = plan_mod.compile_plan(tn.topology, model.layered.merge(
        tn.storage_struct), tn.cfg, FSDP)
    with pytest.raises(ValueError, match="streamed <-> gather-all"):
        elastic.handoff_state(t_st, [1, 3], old_plan=tp, new_plan=ga)


# ---------------------------------------------------------------------------
# In the port: streamed == gather-all, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_trainer(cfg, streamed, microbatch=None, init_state=None, seq=SEQ):
    topo = plan_mod.Topology.hierarchical(("data", "pod"), (DATA, POD),
                                          dcn_axes=("pod",))
    return Trainer(cfg, DATA, pod_axis=POD, device="cpu", sharding="fsdp",
                   streamed=streamed, topology=topo, group_size=S, tau=TAU,
                   seq_len=seq, global_batch=GB, seed=0,
                   microbatch=microbatch, init_state=init_state)


def _canonical_rows(trainer, buffers):
    """Every pod's canonical tree (merged when streamed) as leaves."""
    plan = trainer.plan()
    tree = bucketing.unpack(buffers, plan.shard_layout, cast=False)
    if plan.sharding.streamed:
        tree = trainer.model.layered.merge(tree, lead=1)
    return tr.tree_leaves(tree)


# a tiny-width qwen3-0.6b at vocab 65536: the chunked cross-entropy head
CHUNKED = dict(vocab=65536, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128)


@pytest.mark.parametrize("arch,variant,microbatch,steps", [
    ("tinyllama-1.1b", {}, None, STEPS), ("qwen3-0.6b", {}, 2, STEPS),
    ("qwen3-0.6b", CHUNKED, None, 2)])
def test_streamed_trainer_equals_gather_all_bit_for_bit(arch, variant,
                                                        microbatch, steps,
                                                        one_thread):
    """Both Trainers from one seed, ``steps`` steps (both offsets and the
    sync at ``STEPS``): equal losses as floats, every pod's params and
    momentum bit for bit after every step; with two microbatches a member
    (qwen3-0.6b, tied) and with the chunked head at vocab 65536; the
    streamed run reads ``expected_stream_gathers`` buckets a pod, a
    microbatch and a step."""
    cfg = get_config(arch, smoke=True).variant(**variant)
    ga = _port_trainer(cfg, False, microbatch)
    st = _port_trainer(cfg, True, microbatch)
    plan = st.plan()
    assert plan.shard_layout.grouped and not ga.plan().shard_layout.grouped
    assert (cfg.vocab_padded >= 65536) == bool(variant)
    bits = lambda t: t.view({2: torch.int16, 4: torch.int32}[
        t.element_size()])
    for t in range(steps):
        before = plan.stream_gathers
        assert ga.step_once(t) == st.step_once(t)
        assert plan.stream_gathers - before == \
            streaming.expected_stream_gathers(plan) * POD * (microbatch or 1)
        for tag in ("params", "momentum"):
            a, b = ((tr_.state.params if tag == "params" else
                     tr_.state.opt_state.momentum) for tr_ in (ga, st))
            for x, y in zip(_canonical_rows(ga, a), _canonical_rows(st, b)):
                assert bits(x).equal(bits(y)), (t, tag)
    assert st.state.opt_state.count.tolist() == \
        ga.state.opt_state.count.tolist()
    for a, b in zip(tr.tree_leaves(ga.consolidated()),
                    tr.tree_leaves(st.consolidated())):
        assert bits(a).equal(bits(b))


# ---------------------------------------------------------------------------
# The JAX package on 8 forced host devices: averages and Trainers
# ---------------------------------------------------------------------------

JAX_SCRIPT = """
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.core import bucketing
    from repro.core import plan as plan_mod
    from repro.core.replica import ShardingPolicy
    from repro.launch.train import Trainer

    STREAM = ShardingPolicy.fsdp_within_pod("data", streamed=True)
    out = {{}}
    auto = lambda shape, names: jax.make_mesh(
        shape, names, axis_types=(AxisType.Auto,) * len(names))
    spec = P("pod", "data")

    def topo(name):
        if name == "flat":
            return plan_mod.Topology(("data", "pod"), ({DATA}, {POD}), (
                plan_mod.LinkClass("link", bucket_bytes=4096),), (0, 0))
        return plan_mod.Topology(("data", "pod"), ({DATA}, {POD}), (
            plan_mod.LinkClass("ici", alpha=1e-6, beta=1e-11,
                               bucket_bytes=4096),
            plan_mod.LinkClass("dcn", alpha=5e-5, beta=1e-10,
                               bucket_bytes=4096)), (0, 1))

    rows = np.load({inp!r})
    SPEC = {spec!r}
    tree0 = build(SPEC, lambda p, s: jax.ShapeDtypeStruct(tuple(s[0]),
                                                          jnp.dtype(s[1])))
    pods = [build(SPEC, lambda p, s, e=e: jnp.asarray(
        rows[f"pod{{e}}/{{p}}"]).astype(jnp.dtype(s[1])))
        for e in range({POD})]
    mesh = auto(({POD}, {DATA}), ("pod", "data"))
    for name in ("flat", "hier"):
        plan = plan_mod.compile_plan(topo(name), tree0,
                                     plan_mod.AveragingConfig(group_size={S}),
                                     STREAM)
        packed = [bucketing.pack(t, plan.shard_layout) for t in pods]
        bufs = tuple(jax.device_put(jnp.stack([p[b] for p in packed]),
                                    NamedSharding(mesh, spec))
                     for b in range(plan.shard_layout.n_buckets))
        for ph, off in enumerate(plan.offsets):
            f = compat.shard_map(
                lambda sh, ph=ph: tuple(o[None] for o in plan.average(
                    tuple(s[0] for s in sh), ph)),
                mesh=mesh, in_specs=(spec,), out_specs=spec,
                axis_names={{"pod", "data"}})
            for b, r in enumerate(jax.jit(f)(bufs)):
                out[f"avg/{{name}}/{{off}}/{{b}}"] = np.asarray(r, np.float32)

    tmesh = auto(({POD}, {DATA}, 1), ("pod", "data", "model"))
    htopo = plan_mod.Topology.hierarchical(("data", "pod"), ({DATA}, {POD}),
                                           dcn_axes=("pod",))
    for arch in {ARCHS!r}:
        cfg = get_config(arch, smoke=True).variant(dtype="float32")
        tr_ = Trainer(cfg, tmesh, seq_len={SEQ}, global_batch={GB}, seed=0,
                      topology=htopo, sharding="fsdp", streamed=True,
                      group_size={S}, tau={TAU})
        s0 = jax.device_get(tr_.state)
        for b, (p, m) in enumerate(zip(s0.params, s0.opt_state.momentum)):
            out[f"{{arch}}/params0/{{b}}"] = np.asarray(p, np.float32)
            out[f"{{arch}}/momentum0/{{b}}"] = np.asarray(m)
        with compat.set_mesh(tmesh):
            losses = [tr_.step_once(t) for t in range({STEPS})]
        s1 = jax.device_get(tr_.state)
        for b, (p, m) in enumerate(zip(s1.params, s1.opt_state.momentum)):
            out[f"{{arch}}/params1/{{b}}"] = np.asarray(p, np.float32)
            out[f"{{arch}}/momentum1/{{b}}"] = np.asarray(m)
        out[f"{{arch}}/losses"] = np.asarray(losses)
        out[f"{{arch}}/count"] = np.asarray(s1.opt_state.count)
        out[f"{{arch}}/step_phase"] = np.asarray([int(s1.step),
                                                 int(s1.phase)])
    np.savez({outp!r}, **out)
    print("JAX_STREAMED_DONE")
"""
ARCHS = ("qwen3-0.6b", "tinyllama-1.1b")


def _json_spec(spec):
    """GROUPED as lists: a leaf ``[shape, dtype]``, the spans a list."""
    if isinstance(spec, dict):
        return {k: _json_spec(v) for k, v in spec.items()}
    if isinstance(spec[0], tuple):
        return [list(spec[0]), spec[1]]
    return [_json_spec(v) for v in spec]


BUILD = """
def build(spec, fn, path=""):
    if isinstance(spec, dict):
        return {k: build(v, fn, f"{path}{k}/") for k, v in spec.items()}
    if isinstance(spec[1], str):
        return fn(path, spec)
    return tuple(build(v, fn, f"{path}{i}/") for i, v in enumerate(spec))
"""
exec(BUILD)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("streamed")
    rng = np.random.default_rng(0)
    rows = {}
    for e in range(POD):
        build(_json_spec(GROUPED), lambda p, s, e=e: rows.__setitem__(
            f"pod{e}/{p}", rng.normal(size=s[0]).astype(np.float32)))
    np.savez(d / "in.npz", **rows)
    out = run_sub(JAX_SCRIPT.format(
        inp=str(d / "in.npz"), outp=str(d / "out.npz"),
        spec=_json_spec(GROUPED), DATA=DATA, POD=POD, S=S, TAU=TAU, SEQ=SEQ,
        GB=GB, STEPS=STEPS, ARCHS=ARCHS), devices=DATA * POD, timeout=900,
        preamble=BUILD)
    assert "JAX_STREAMED_DONE" in out
    return rows, dict(np.load(d / "out.npz"))


@pytest.mark.parametrize("topo", ["flat", "hier"])
def test_streamed_average_matches_jax_every_offset(jax_runs, topo):
    """The pod-to-pod butterfly over the grouped shard layout (K1/K2's
    plain versions on the CPU) equals the JAX plan's bit for bit on every
    offset, flat and hierarchical."""
    rows, res = jax_runs
    t = _ttree(GROUPED)
    links = ((plan_mod.LinkClass("link", bucket_bytes=4096),), (0, 0)) \
        if topo == "flat" else ((
            plan_mod.LinkClass("ici", alpha=1e-6, beta=1e-11,
                               bucket_bytes=4096),
            plan_mod.LinkClass("dcn", alpha=5e-5, beta=1e-10,
                               bucket_bytes=4096)), (0, 1))
    tp = plan_mod.compile_plan(plan_mod.Topology(("data", "pod"),
                                                 (DATA, POD), *links), t,
                               plan_mod.AveragingConfig(group_size=S), STREAM)
    assert tp.shard_layout.grouped and len(tp.offsets) > 1
    pods = [build(_json_spec(GROUPED), lambda p, s, e=e: torch.from_numpy(
        rows[f"pod{e}/{p}"]).to(TORCH_DT[s[1]])) for e in range(POD)]
    bufs = tp.shard_tree(tr.tree_map(lambda *xs: torch.stack(xs), *pods))
    for off in tp.offsets:
        for b, g in enumerate(tp.average_offset(bufs, off)):
            assert _bits_equal(g, res[f"avg/{topo}/{off}/{b}"]), (off, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_streamed_trainer_matches_jax_trainer(jax_runs, arch, one_thread):
    """Five steps of ``Trainer(sharding="fsdp", streamed=True)`` from the
    JAX run's initial shard buffers: losses, every buffer of params and
    momentum (to RTOL of its largest magnitude), counts, step and
    phase."""
    _, res = jax_runs
    cfg = get_config(arch, smoke=True).variant(dtype="float32")
    n = len([k for k in res if k.startswith(f"{arch}/params0/")])
    state = ReplicaState(
        tuple(torch.tensor(res[f"{arch}/params0/{b}"]) for b in range(n)),
        SGDState(tuple(torch.tensor(res[f"{arch}/momentum0/{b}"])
                       for b in range(n)),
                 torch.zeros(POD, dtype=torch.int32)))
    trainer = _port_trainer(cfg, True, init_state=state)
    plan = trainer.plan()
    assert plan.sharding == STREAM and plan.shard_layout.n_buckets == n
    losses = [trainer.step_once(t) for t in range(STEPS)]
    np.testing.assert_allclose(losses, res[f"{arch}/losses"], rtol=RTOL,
                               atol=RTOL)
    assert (trainer.state.step, trainer.state.phase) == \
        tuple(res[f"{arch}/step_phase"])
    assert trainer.state.opt_state.count.tolist() == \
        res[f"{arch}/count"].tolist()
    assert trainer.skipped_nonfinite == 0
    for tag, got in (("params", trainer.state.params),
                     ("momentum", trainer.state.opt_state.momentum)):
        for b, g in enumerate(got):
            w = res[f"{arch}/{tag}1/{b}"]
            scale = float(np.abs(w).max()) or 1.0
            np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                       atol=RTOL * scale, err_msg=tag)
