"""The port's FSDP-within-pod replicas (``ShardingPolicy.fsdp_within_pod``)
against the JAX package's, in float32 at smoke size.

Host-side, in this process: the policy's validation, ``effective_rank_map``,
the shard-aligned layouts and shard structs (exact, for the reference
tests' tiny tree at a 4096-byte budget and for tinyllama-1.1b's real tree),
the plan cache, launch counts, the cross-policy conversions and templates,
checkpoints written by either package and restored across policies by the
other, ``serving_weights_from_checkpoint`` of an FSDP manifest and the
sharded elastic handoff.

On 8 forced host devices with Auto axes (ROADMAP.md F1), in one
subprocess: the JAX plan's ``average`` on every phase offset, flat and
hierarchical, overlapped and serial, which the port's
``_average_sharded`` (K1/K2's plain versions on the CPU) must equal bit for
bit; its ``sync``; its ``grad_shards`` at pod sizes 2 and 4; six steps of
the JAX ``Trainer(sharding="fsdp")`` under ``wagma`` (also with two
microbatches) and ``allreduce``, which the port's ``Trainer`` must
follow; and a step whose batch poisons
one member's rows (the pod-wide non-finite guard)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subproc import run_sub

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_config
from repro.core import elastic as jelastic
from repro.core import plan as jplan_mod
from repro.core import replica as jreplica
from repro.models.registry import build_model as jax_build
from repro.optim.sgd import SGDState as JSGDState
from repro.serve import handoff as jhandoff
from repro_torch.checkpoint import load_replica_state, save_replica_state
from repro_torch.configs import get_config
from repro_torch.core import elastic, replica
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.core.baselines import make_averager
from repro_torch.core.replica import (FSDP_SLICE, ReplicaState,
                                      ShardingPolicy, effective_rank_map)
from repro_torch.launch.train import Trainer, resolve_sharding
from repro_torch.models import transformer as tfm
from repro_torch.optim.sgd import SGDState
from repro_torch.serve.handoff import serving_weights_from_checkpoint

ARCH, DATA, POD, S, TAU, SEQ, GB, STEPS = ("tinyllama-1.1b", 2, 4, 2, 5, 16,
                                           16, 6)
# the Trainer runs' tolerance, as tests/test_torch_train.py holds the
# replicated Trainer: matmul and reduction orders differ between the
# backends
RTOL = 1e-5
FSDP = ShardingPolicy.fsdp_within_pod("data")
JFSDP = jreplica.ShardingPolicy.fsdp_within_pod("data")

# the JAX package's test tree (tests/test_replica.py): f32, bf16 and an
# empty leaf
TREE = {"emb": ((33, 70), "float32"), "w": ((1300,), "float32"),
        "h": ((300,), "bfloat16"), "e": ((0, 4), "float32")}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jtree():
    return {k: jax.ShapeDtypeStruct(s, jnp.dtype(d))
            for k, (s, d) in TREE.items()}


def _ttree():
    return {k: tr.Spec(s, TORCH_DT[d]) for k, (s, d) in TREE.items()}


def _links(name, budget):
    return dict(flat=(plan_mod.LinkClass("link", bucket_bytes=budget),),
                hier=(plan_mod.LinkClass("ici", alpha=1e-6, beta=1e-11,
                                         bucket_bytes=budget),
                      plan_mod.LinkClass("dcn", alpha=5e-5, beta=1e-10,
                                         bucket_bytes=budget)))[name]


def _topos(name, sizes=(DATA, POD), budget=4096):
    """(port, JAX) topologies over ("data", "pod"): one link class, or ICI
    data and DCN pod, each pinned to ``budget``."""
    links = _links(name, budget)
    cls = (0, 0) if name == "flat" else (0, 1)
    links = links[:1] if name == "flat" else links
    t = plan_mod.Topology(("data", "pod"), tuple(sizes), links, cls)
    j = jplan_mod.Topology(("data", "pod"), tuple(sizes), tuple(
        jplan_mod.LinkClass(l.name, l.alpha, l.beta, l.gamma, l.bucket_bytes)
        for l in links), cls)
    return t, j


def _plans(name, sizes=(DATA, POD), *, overlap=True, tree=None, jtree=None):
    t, j = _topos(name, sizes)
    tp = plan_mod.compile_plan(t, tree or _ttree(), plan_mod.AveragingConfig(
        group_size=S, overlap=overlap), FSDP)
    jp = jplan_mod.compile_plan(j, jtree or _jtree(), jplan_mod.AveragingConfig(
        group_size=S, overlap=overlap), JFSDP)
    return tp, jp


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _torch(a, dtype=None) -> torch.Tensor:
    """A numpy or JAX array as a CPU tensor in ``dtype`` (default: its own;
    bfloat16 crosses through float32, exactly)."""
    dt = np.dtype(a.dtype)
    out = torch.from_numpy(np.array(a, dtype=np.float32 if dt.name ==
                                    "bfloat16" else dt))
    if dtype is None and dt.name == "bfloat16":
        dtype = torch.bfloat16
    return out.to(dtype) if dtype is not None else out


def _bits_equal(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _pod_trees(rng, n):
    """``n`` random trees of TREE (numpy float32; "h" rounded to bf16)."""
    out = []
    for _ in range(n):
        t = {}
        for k, (shape, d) in TREE.items():
            a = rng.normal(size=shape).astype(np.float32)
            if d == "bfloat16":
                a = np.asarray(jnp.asarray(a).astype(jnp.bfloat16),
                               np.float32)
            t[k] = a
        out.append(t)
    return out


def _stack_t(trees):
    return {k: torch.stack([_torch(t[k], TORCH_DT[TREE[k][1]])
                            for t in trees]) for k in TREE}


def _stack_j(trees):
    return {k: jnp.stack([jnp.asarray(t[k]).astype(jnp.dtype(TREE[k][1]))
                          for t in trees]) for k in TREE}


# ---------------------------------------------------------------------------
# Policy, layouts and plans (host side)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [("zero3",), ("fsdp_within_pod",),
                                  ("replicated", "data"),
                                  ("replicated", None, True)])
def test_sharding_policy_validation_matches_jax(args):
    with pytest.raises(ValueError):
        jreplica.ShardingPolicy(*args)
    with pytest.raises(ValueError):
        ShardingPolicy(*args)
    pol, jpol = FSDP, JFSDP
    assert pol.is_sharded and pol.shard_axis == "data"
    assert pol.describe() == jpol.describe()
    assert replica.REPLICATED.describe() == jreplica.REPLICATED.describe()
    assert not replica.REPLICATED.is_sharded


@pytest.mark.parametrize("sizes,axis", [((4, 2), 0), ((4, 2), 1),
                                        ((2, 4), 0), ((2, 2, 2), 1),
                                        ((8,), 0)])
def test_effective_rank_map_matches_jax(sizes, axis):
    np.testing.assert_array_equal(effective_rank_map(sizes, axis),
                                  jreplica.effective_rank_map(sizes, axis))


def _assert_same_layout(lay, jlay):
    assert lay.bucket_sizes == jlay.bucket_sizes
    assert [str(d).split(".")[-1] for d in lay.bucket_dtypes] == \
        [np.dtype(d).name for d in jlay.bucket_dtypes]
    assert [(s.bucket, s.offset, s.size, s.shape) for s in lay.slots] == \
        [(s.bucket, s.offset, s.size, s.shape) for s in jlay.slots]


def _tinyllama_trees(smoke=False):
    cfg = get_config(ARCH, smoke=smoke)
    jm = jax_build(jax_config(ARCH, smoke=smoke))
    return (tfm.param_specs(cfg),
            jax.eval_shape(jm.init, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("tree", ["test", "tinyllama"])
@pytest.mark.parametrize("topo,sizes", [("flat", (2, 4)), ("hier", (2, 4)),
                                        ("hier", (4, 2))])
def test_shard_layout_and_struct_match_jax(tree, topo, sizes):
    """Bucket for bucket (sizes, dtypes, offsets, padding, the empty
    leaf): the tests' 4096-byte budget on the test tree; tinyllama-1.1b's
    real tree at the link classes' own modeled budgets."""
    if tree == "test":
        tp, jp = _plans(topo, sizes)
    else:
        t, j = _topos(topo, sizes, budget=None)
        ptree, jtree = _tinyllama_trees()
        tp = plan_mod.compile_plan(t, ptree, plan_mod.AveragingConfig(
            group_size=S), FSDP)
        jp = jplan_mod.compile_plan(j, jtree, jplan_mod.AveragingConfig(
            group_size=S), JFSDP)
    assert (tp.shard_size, tp.P_eff, tp.S) == (jp.shard_size, jp.P_eff,
                                               jp.S)
    assert tp.shard_bucket_bytes == jp.shard_bucket_bytes
    assert tp.offsets == jp.offsets
    _assert_same_layout(tp.shard_layout, jp.shard_layout)
    assert all(n % (tp.shard_size * 128) == 0
               for n in tp.shard_layout.bucket_sizes)
    assert [(s.shape, str(s.dtype).split(".")[-1]) for s in tp.shard_struct()] \
        == [(tuple(s.shape), np.dtype(s.dtype).name)
            for s in jp.shard_struct()]
    for off in tp.offsets:
        got = [{k: r[k] for k in ("link", "bits", "axes", "stages",
                                  "bucket_bytes", "n_buckets")}
               for r in tp.butterfly_summary(off)]
        want = [{k: r[k] for k in ("link", "bits", "axes", "stages",
                                   "bucket_bytes", "n_buckets")}
                for r in jp.butterfly_summary(off)]
        assert got == want
        assert sum(r["exchanges"] for r in tp.butterfly_summary(off)) == \
            jp.expected_ppermutes(off)
    if tree == "test":
        assert tp.shard_layout.n_buckets > 1
        assert "shard layout" in tp.describe()


def test_fsdp_validation_matches_jax():
    t, j = _topos("hier", (4, 2))
    for pol, jpol, match in (
            (ShardingPolicy.fsdp_within_pod("pod"),
             jreplica.ShardingPolicy.fsdp_within_pod("pod"), "bottleneck"),
            (ShardingPolicy.fsdp_within_pod("model"),
             jreplica.ShardingPolicy.fsdp_within_pod("model"), "not a dp")):
        with pytest.raises(ValueError, match=match):
            jplan_mod.compile_plan(j, _jtree(), jplan_mod.AveragingConfig(
                group_size=2), jpol)
        with pytest.raises(ValueError, match=match):
            plan_mod.compile_plan(t, _ttree(), plan_mod.AveragingConfig(
                group_size=2), pol)
    # the group size is bounded by the pod world, not the dp world
    with pytest.raises(ValueError, match="replica world"):
        plan_mod.compile_plan(t, _ttree(), plan_mod.AveragingConfig(
            group_size=4), FSDP)
    with pytest.raises(ValueError, match="replica world"):
        jplan_mod.compile_plan(j, _jtree(), jplan_mod.AveragingConfig(
            group_size=4), JFSDP)
    with pytest.raises(ValueError, match="only dp axis"):
        plan_mod.compile_plan(plan_mod.Topology.flat(("data",), (8,)),
                              _ttree(), plan_mod.AveragingConfig(), FSDP)


def test_plan_cache_resolves_the_shard_buffers():
    t, _ = _topos("hier", (4, 2))
    cfg = plan_mod.AveragingConfig(group_size=2)
    p_rep = plan_mod.compile_plan(t, _ttree(), cfg)
    p_fsdp = plan_mod.compile_plan(t, _ttree(), cfg, FSDP)
    assert p_rep is not p_fsdp
    assert plan_mod.compile_plan(t, _ttree(), cfg, FSDP) is p_fsdp
    lay = p_fsdp.shard_layout
    for dtypes in (lay.bucket_dtypes, (torch.float32,) * lay.n_buckets):
        rows = tuple(torch.zeros((p_fsdp.P_eff, n), dtype=d)
                     for n, d in zip(lay.bucket_sizes, dtypes))
        av = make_averager("wagma", ("data", "pod"), (4, 2), group_size=2,
                           topology=t, sharding=FSDP)
        assert av.plan_for(rows) is p_fsdp and av.P_eff == 2
    assert plan_mod.evict_topology(t) >= 3
    assert plan_mod.compile_plan(t, _ttree(), cfg, FSDP) is not p_fsdp


def test_launch_counts_unchanged_by_sharding(monkeypatch):
    """One exchange per shard bucket per stage (sharding never multiplies
    the count by the pod size), the K1/K2 batches of the replicated plan
    over the pods at the same budget, and the JAX plan's expected
    ppermutes (tests/test_replica.py's launch-count test)."""
    from repro_torch.kernels import ops
    tree = {f"l{i}": tr.Spec((700,), torch.float32) for i in range(6)}
    jtree = {f"l{i}": jax.ShapeDtypeStruct((700,), jnp.float32)
             for i in range(6)}
    link = plan_mod.LinkClass("link", bucket_bytes=4096)
    cfg = plan_mod.AveragingConfig(group_size=2, bucket_bytes=4096)
    p_fsdp = plan_mod.compile_plan(
        plan_mod.Topology.flat(("data", "pod"), (4, 2), link=link), tree,
        cfg, FSDP)
    p_rep = plan_mod.compile_plan(plan_mod.Topology.flat(("pod",), (2,)),
                                  tree, cfg)
    jp = jplan_mod.compile_plan(
        jplan_mod.Topology.flat(("data", "pod"), (4, 2),
                                link=jplan_mod.LinkClass(
                                    "link", bucket_bytes=4096)), jtree,
        jplan_mod.AveragingConfig(group_size=2, bucket_bytes=4096), JFSDP)
    n = p_fsdp.shard_layout.n_buckets
    assert n == p_rep.class_layout(0).n_buckets > 1

    calls = []
    for name in ("group_average_combine", "group_average_combine_multi"):
        real = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _n=name, _f=real, **k: (
            calls.append(_n), _f(*a, **k))[1])
    for off in p_fsdp.offsets:
        stages = len(p_fsdp.runs_for_offset(off)[0].bits)
        counts = []
        for p, tree_in in ((p_fsdp, tuple(torch.ones(2, s) for s in
                                          p_fsdp.shard_layout.bucket_sizes)),
                           (p_rep, {k: torch.ones(2, 700) for k in tree})):
            sent = []
            wire = plan_mod.STACKED_WIRE
            monkeypatch.setattr(p, "wire", type("Counting", (), {
                "butterfly_exchange": staticmethod(
                    lambda b, bit: (sent.append(bit),
                                    wire.butterfly_exchange(b, bit))[1])})())
            calls.clear()
            p.average_offset(tree_in, off)
            counts.append((len(sent), list(calls)))
        assert counts[0] == counts[1]
        assert counts[0][0] == n * stages == jp.expected_ppermutes(off)


def _pod_identical_states(sizes, seed=0):
    """A replicated (P, ...) state whose pod members hold identical
    weights, as both packages' ReplicaStates, and both sharded plans."""
    tp, jp = _plans("hier", sizes)
    rng = np.random.default_rng(seed)
    eff = effective_rank_map(sizes, 0)
    pods = _pod_trees(rng, tp.P_eff)
    moms = [{k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in t.items()} for t in pods]
    by_rank = lambda ts: [ts[e] for e in eff]
    t_params, j_params = _stack_t(by_rank(pods)), _stack_j(by_rank(pods))
    t_mom = {k: torch.stack([torch.from_numpy(m[k]) for m in by_rank(moms)])
             for k in TREE}
    j_mom = {k: jnp.stack([m[k] for m in by_rank(moms)]) for k in TREE}
    count = (3 * eff + 1).astype(np.int32)     # one count a pod
    t_state = ReplicaState(t_params, SGDState(t_mom, torch.from_numpy(count)),
                           7, 1)
    j_state = jreplica.ReplicaState.create(
        j_params, JSGDState(j_mom, jnp.asarray(count)), step=7,
        phase=1)
    return tp, jp, t_state, j_state


def _assert_states_equal(got, want):
    assert isinstance(got.params, tuple) == isinstance(want.params, tuple)
    g_leaves = tr.tree_leaves((got.params, got.opt_state))
    w_leaves = jax.tree.leaves((want.params, want.opt_state))
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert tuple(g.shape) == tuple(np.shape(w))
        assert _bits_equal(g, w)
    assert (int(got.step), int(got.phase)) == (int(want.step),
                                               int(want.phase))


@pytest.mark.parametrize("sizes", [(2, 4), (4, 2)])
def test_cross_policy_round_trip_matches_jax(sizes):
    """replicated -> FSDP -> replicated, bit for bit in both packages and
    between them, at pod size 2 and 4; and a diverged replicated state's
    pod-mean projection (summed in rank order, as numpy does)."""
    tp, jp, ts, js = _pod_identical_states(sizes)
    t_fsdp = replica.replicated_to_fsdp_state(ts, tp)
    j_fsdp = jreplica.replicated_to_fsdp_state(js, jp)
    _assert_states_equal(t_fsdp, j_fsdp)
    back = replica.fsdp_to_replicated_state(t_fsdp, tp)
    _assert_states_equal(back, jreplica.fsdp_to_replicated_state(j_fsdp,
                                                                  jp))
    _assert_states_equal(back, js)
    # members apart: the pod mean in float32
    rng = np.random.default_rng(5)
    apart = _pod_trees(rng, tp.P)
    got = replica.replicated_to_sharded_tree(_stack_t(apart), tp)
    want = jreplica.replicated_to_sharded_tree(_stack_j(apart), jp)
    assert all(_bits_equal(g, w) for g, w in zip(got, want))
    # consolidation: the pods' mean, unpacked
    cons = replica.consolidate_state(t_fsdp, tp)
    jcons = jreplica.consolidate_state(j_fsdp, jp)
    for k in TREE:
        np.testing.assert_allclose(_np(cons[k]), _np(jcons[k]), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="sharded plan"):
        replica.consolidate_state(t_fsdp)


def test_state_templates_match_jax():
    tp, jp, ts, js = _pod_identical_states((4, 2))
    t_fsdp = replica.replicated_to_fsdp_state(ts, tp)
    j_fsdp = jreplica.replicated_to_fsdp_state(js, jp)
    pairs = ((replica.sharded_state_template(tp, ts.opt_state),
              jreplica.sharded_state_template(jp, js.opt_state), t_fsdp),
             (replica.replicated_state_template(tp, t_fsdp.opt_state),
              jreplica.replicated_state_template(jp, j_fsdp.opt_state), ts))
    for tpl, jtpl, state in pairs:
        got = tr.tree_leaves((tpl.params, tpl.opt_state))
        want = jax.tree.leaves((jtpl.params, jtpl.opt_state))
        real = tr.tree_leaves((state.params, state.opt_state))
        assert [tuple(s.shape) for s in got] == [tuple(s.shape)
                                                 for s in want]
        assert [str(s.dtype).split(".")[-1] for s in got] == \
            [np.dtype(s.dtype).name for s in want]
        assert [(tuple(s.shape), s.dtype) for s in got] == \
            [(tuple(r.shape), r.dtype) for r in real]


def _fsdp_state(sizes=(DATA, POD)):
    tp, jp, ts, js = _pod_identical_states(sizes)
    return (tp, jp, replica.replicated_to_fsdp_state(ts, tp),
            jreplica.replicated_to_fsdp_state(js, jp))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_fsdp_checkpoints_cross_packages_and_policies(direction, tmp_path):
    """A checkpoint written under FSDP by either package loads into the
    other as FSDP, and restores there as replicated (and the replicated one
    back as FSDP) equal to the writer's own conversion."""
    tp, jp, t_fsdp, j_fsdp = _fsdp_state()
    path = str(tmp_path / "fsdp")
    rpath = str(tmp_path / "replicated")
    t_rep = replica.fsdp_to_replicated_state(t_fsdp, tp)
    j_rep = jreplica.fsdp_to_replicated_state(j_fsdp, jp)
    t_tpl = replica.sharded_state_template(tp, t_fsdp.opt_state)
    j_tpl = jreplica.sharded_state_template(jp, j_fsdp.opt_state)
    t_rtpl = replica.replicated_state_template(tp, t_fsdp.opt_state)
    j_rtpl = jreplica.replicated_state_template(jp, j_fsdp.opt_state)
    if direction == "jax_to_port":
        jckpt.save_replica_state(path, j_fsdp, sharding=JFSDP)
        jckpt.save_replica_state(rpath, j_rep)
        _assert_states_equal(load_replica_state(path, t_tpl, sharding=FSDP),
                             j_fsdp)
        _assert_states_equal(load_replica_state(path, t_rtpl, plan=tp),
                             j_rep)
        _assert_states_equal(load_replica_state(rpath, t_tpl, sharding=FSDP,
                                                plan=tp), j_fsdp)
        with pytest.raises(ValueError, match="pass the compiled plan"):
            load_replica_state(path, t_rtpl)
    else:
        save_replica_state(path, t_fsdp, sharding=FSDP)
        save_replica_state(rpath, t_rep)
        with open(f"{path}/manifest.json") as f:
            meta = json.load(f)["metadata"]
        assert (meta["sharding"], meta["shard_axis"], meta["streamed"]) == \
            ("fsdp_within_pod", "data", False)
        _assert_states_equal(t_fsdp, jckpt.load_replica_state(
            path, j_tpl, sharding=JFSDP))
        _assert_states_equal(t_rep, jckpt.load_replica_state(
            path, j_rtpl, plan=jp))
        _assert_states_equal(t_fsdp, jckpt.load_replica_state(
            rpath, j_tpl, sharding=JFSDP, plan=jp))


def test_serving_weights_from_an_fsdp_checkpoint(tmp_path):
    tp, jp, t_fsdp, j_fsdp = _fsdp_state()
    path = str(tmp_path / "fsdp")
    jckpt.save_replica_state(path, j_fsdp, sharding=JFSDP)
    got = serving_weights_from_checkpoint(
        path, replica.sharded_state_template(tp, t_fsdp.opt_state), plan=tp)
    want = jhandoff.serving_weights_from_checkpoint(
        path, jreplica.sharded_state_template(jp, j_fsdp.opt_state),
        plan=jp)
    for k in TREE:
        assert got[k].dtype == TORCH_DT[TREE[k][1]]
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=1e-6,
                                   atol=1e-6)
    # the pods hold one model each; after the conversion the mean of 4
    # distinct pods is the consensus both packages serve
    from repro_torch.serve.handoff import serving_weights_from_state
    direct = serving_weights_from_state(t_fsdp, plan=tp)
    for k in TREE:
        assert torch.equal(direct[k], got[k])


def test_handoff_state_sharded_shrink_matches_jax():
    """Pods 1 and 3 of 4 survive a shrink to (data 2, pod 2): unpacked
    through the old plan's layout, selected, repacked through the new
    plan's (at another budget), as the JAX package does."""
    tp, jp, t_fsdp, j_fsdp = _fsdp_state()
    t_new, j_new = _topos("hier", (2, 2), budget=16384)
    tn = plan_mod.compile_plan(t_new, _ttree(), plan_mod.AveragingConfig(
        group_size=2), FSDP)
    jn = jplan_mod.compile_plan(j_new, _jtree(), jplan_mod.AveragingConfig(
        group_size=2), JFSDP)
    assert tn.shard_layout.bucket_sizes != tp.shard_layout.bucket_sizes
    got = elastic.handoff_state(t_fsdp, [1, 3], old_plan=tp, new_plan=tn)
    want = jelastic.handoff_state(j_fsdp, [1, 3], old_plan=jp, new_plan=jn)
    _assert_states_equal(got, want)
    with pytest.raises(ValueError, match="P_eff"):
        elastic.handoff_state(t_fsdp, [1], old_plan=tp, new_plan=tn)
    with pytest.raises(ValueError, match="sharding policies"):
        elastic.handoff_state(t_fsdp, [1, 3], old_plan=tp)


def test_streamed_and_rank_worlds_raise_naming_slice_7b():
    """The streamed spellings resolve to the streamed policy (ported,
    tests/test_torch_streaming.py).  Over a rank world the gather-all and
    the streamed plans and both averagers build (slices 7c-1 and 7c-2,
    tests/test_torch_fsdp_ranks.py and tests/test_torch_streamed_ranks.py),
    each averaging on the world's pod view; over a world with a model axis
    they build too (slice 7c-3, tests/test_torch_fsdp_model.py), and the
    pod view keeps this rank's model coordinate."""
    from repro_torch.core.replica import (FSDP_MODEL_SLICE,
                                          FSDP_STREAMED_SLICE)
    from repro_torch.launch.mesh import RankWorld
    streamed = ShardingPolicy.fsdp_within_pod("data", streamed=True)
    assert streamed.is_sharded and streamed.streamed
    for make in (lambda: resolve_sharding("fsdp_streamed", ("data", "pod")),
                 lambda: resolve_sharding("fsdp", ("data", "pod"),
                                          streamed=True),
                 lambda: resolve_sharding(FSDP, ("data", "pod"),
                                          streamed=True)):
        assert make() == streamed
        assert make().describe() == jreplica.ShardingPolicy.fsdp_within_pod(
            "data", streamed=True).describe()
    assert "slice 7c" in FSDP_SLICE
    for part in (FSDP_STREAMED_SLICE, FSDP_MODEL_SLICE):
        assert "slice 7c" in part and part in FSDP_SLICE
    world = RankWorld(("data", "pod"), (2, 2), 3, torch.device("cpu"), "gloo")
    t, _ = _topos("hier", (2, 2))
    # the streamed policy compiles over a layered tree
    layered = {"stem": {"emb": _ttree()["emb"]},
               "layers": ({"w": _ttree()["w"]}, {"w": _ttree()["w"]}),
               "head": {"h": _ttree()["h"], "e": _ttree()["e"]}}
    trees = {FSDP: _ttree(), streamed: layered}
    builds = {
        "wagma": lambda pol, w: make_averager(
            "wagma", ("data", "pod"), (2, 2), topology=t, sharding=pol,
            world=w),
        "allreduce": lambda pol, w: make_averager(
            "allreduce", ("data", "pod"), (2, 2), topology=t, sharding=pol,
            world=w),
        "plan": lambda pol, w: plan_mod.compile_plan(
            t, trees[pol], plan_mod.AveragingConfig(), pol, w)}
    assert "ported" in FSDP_STREAMED_SLICE
    for name, build in builds.items():
        for pol in (FSDP, streamed):
            built = build(pol, world)
            plan = built if name == "plan" else built.plan_for(
                tr.tree_map(lambda v: tr.Spec((1,) + tuple(v.shape),
                                              v.dtype), trees[pol]))
            assert plan.world is world and plan.P_eff == 2
            assert plan.sharding == pol
            assert plan.shard_layout.grouped == pol.streamed
            # the butterfly runs pod to pod: pod 1's member at data 1
            assert (plan.wire.world.rank, plan.wire.world.torch_ranks) == \
                (1, (1, 3))
            assert [tuple(s.shape) for s in plan.shard_struct()] == \
                [(n // 2,) for n in plan.shard_layout.bucket_sizes]
        # model rank 1 of dp rank 1 (data 1, pod 0): torch rank 3
        model_world = RankWorld(("data", "pod"), (2, 2), 1,
                                torch.device("cpu"), "gloo", model=2,
                                model_rank=1)
        assert "ported" in FSDP_MODEL_SLICE
        for pol in (FSDP, streamed):
            built = build(pol, model_world)
            plan = built if name == "plan" else built.plan_for(
                tr.tree_map(lambda v: tr.Spec((1,) + tuple(v.shape),
                                              v.dtype), trees[pol]))
            assert plan.world == model_world and plan.P_eff == 2
            assert plan.shard_layout.grouped == pol.streamed
            # pod to pod at data 1, model 1: torch ranks 1 * 2 + 1, 3 * 2 + 1
            assert (plan.wire.world.rank, plan.wire.world.torch_ranks) == \
                (0, (3, 7))
            assert model_world.shard_members("data") == (1, 3)


# ---------------------------------------------------------------------------
# The JAX package on 8 forced host devices: averages, grad shards, Trainers
# ---------------------------------------------------------------------------

JAX_SCRIPT = """
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.core import bucketing
    from repro.core import plan as plan_mod
    from repro.core.replica import ShardingPolicy
    from repro.launch.train import Trainer

    FSDP = ShardingPolicy.fsdp_within_pod("data")
    out = {{}}
    auto = lambda shape, names: jax.make_mesh(
        shape, names, axis_types=(AxisType.Auto,) * len(names))
    spec = P("pod", "data")

    def links(name):
        if name == "flat":
            return (plan_mod.LinkClass("link", bucket_bytes=4096),), (0, 0)
        return (plan_mod.LinkClass("ici", alpha=1e-6, beta=1e-11,
                                   bucket_bytes=4096),
                plan_mod.LinkClass("dcn", alpha=5e-5, beta=1e-10,
                                   bucket_bytes=4096)), (0, 1)

    def topo(name, sizes):
        ls, cls = links(name)
        return plan_mod.Topology(("data", "pod"), sizes, ls, cls)

    TREE = {tree!r}
    rows = np.load({inp!r})
    cast = lambda a, k: jnp.asarray(a).astype(jnp.dtype(TREE[k][1]))
    tree0 = {{k: jax.ShapeDtypeStruct(tuple(s), jnp.dtype(d))
              for k, (s, d) in TREE.items()}}

    def on_mesh(plan, fn, bufs, mesh):
        f = compat.shard_map(
            lambda sh: tuple(o[None] for o in fn(tuple(s[0] for s in sh))),
            mesh=mesh, in_specs=(spec,), out_specs=spec,
            axis_names={{"pod", "data"}})
        return jax.jit(f)(tuple(jax.device_put(b, NamedSharding(mesh, spec))
                                for b in bufs))

    # plan.average on every offset and plan.sync, from the same buffers
    mesh = auto(({POD}, {DATA}), ("pod", "data"))
    pods = [{{k: cast(rows[f"pod{{e}}/{{k}}"], k) for k in TREE}}
            for e in range({POD})]
    for name in ("flat", "hier"):
        for mode, overlap in (("overlap", True), ("serial", False)):
            plan = plan_mod.compile_plan(
                topo(name, ({DATA}, {POD})), tree0,
                plan_mod.AveragingConfig(group_size={S}, overlap=overlap),
                FSDP)
            packed = [bucketing.pack(t, plan.shard_layout) for t in pods]
            bufs = [jnp.stack([p[b] for p in packed])
                    for b in range(plan.shard_layout.n_buckets)]
            for ph, off in enumerate(plan.offsets):
                res = on_mesh(plan, lambda sh, ph=ph: plan.average(sh, ph),
                              bufs, mesh)
                for b, r in enumerate(res):
                    out[f"avg/{{name}}/{{mode}}/{{off}}/{{b}}"] = np.asarray(
                        r, np.float32)
            if mode == "overlap":
                res = on_mesh(plan, plan.sync, bufs, mesh)
                for b, r in enumerate(res):
                    out[f"sync/{{name}}/{{b}}"] = np.asarray(r, np.float32)

    # grad_shards: every device its own gradient tree (rank = pod*D + data)
    for data, pod in (({DATA}, {POD}), ({POD}, {DATA})):
        plan = plan_mod.compile_plan(
            topo("hier", (data, pod)), tree0,
            plan_mod.AveragingConfig(group_size=2), FSDP)
        m = auto((pod, data), ("pod", "data"))
        grads = {{k: cast(rows[f"grads/{{k}}"], k) for k in TREE}}
        g = compat.shard_map(
            lambda t: tuple(o[None] for o in plan.grad_shards(
                jax.tree.map(lambda a: a[0], t))),
            mesh=m, in_specs=(P(("pod", "data")),), out_specs=spec,
            axis_names={{"pod", "data"}})
        res = jax.jit(g)(jax.tree.map(lambda a: jax.device_put(
            a, NamedSharding(m, P(("pod", "data")))), grads))
        for b, r in enumerate(res):
            out[f"grads/{{pod}}/{{b}}"] = np.asarray(r)

    # Trainers: sharded over data, pods of {DATA}, hierarchical topology
    def flat(prefix, tree):
        return {{prefix + "/".join(str(getattr(k, "idx", getattr(k, "key",
                 getattr(k, "name", k)))) for k in path): np.asarray(v)
                for path, v in jax.tree_util.tree_leaves_with_path(tree)}}

    cfg = get_config({arch!r}, smoke=True).variant(dtype="float32")
    tmesh = auto(({POD}, {DATA}, 1), ("pod", "data", "model"))
    htopo = plan_mod.Topology.hierarchical(("data", "pod"), ({DATA}, {POD}),
                                           dcn_axes=("pod",))

    def trainer(averager, microbatch=None):
        kw = dict(group_size={S}, tau={TAU}) if averager == "wagma" else {{}}
        return Trainer(cfg, tmesh, averager=averager, seq_len={SEQ},
                       global_batch={GB}, seed=0, topology=htopo,
                       sharding="fsdp", microbatch=microbatch, **kw)

    for name, (averager, microbatch) in {RUNS!r}.items():
        tr_ = trainer(averager, microbatch)
        s0 = jax.device_get(tr_.state)
        out.update(flat(f"{{name}}/params0/", s0.params))
        out.update(flat(f"{{name}}/momentum0/", s0.opt_state.momentum))
        with compat.set_mesh(tmesh):
            losses = [tr_.step_once(t) for t in range({STEPS})]
        s1 = jax.device_get(tr_.state)
        out.update(flat(f"{{name}}/params1/", s1.params))
        out.update(flat(f"{{name}}/momentum1/", s1.opt_state.momentum))
        out[f"{{name}}/losses"] = np.asarray(losses)
        out[f"{{name}}/count"] = np.asarray(s1.opt_state.count)
        out[f"{{name}}/step_phase"] = np.asarray([int(s1.step),
                                                 int(s1.phase)])
        out[f"{{name}}/skipped"] = np.asarray(tr_.skipped_nonfinite)

    # the guard: a NaN in rank {BAD}'s mask poisons its member's gradient
    tr_ = trainer("wagma")
    nb = tr_.batch_fn(0, 0, {GB})
    b = {GB} // ({DATA} * {POD})
    mask = np.ones(nb["labels"].shape, np.float32)
    mask[{BAD} * b:({BAD} + 1) * b] = np.nan
    nb["mask"] = mask
    batch = {{k: jax.device_put(jnp.asarray(v), tr_._batch_sharding(
        jnp.asarray(v))) for k, v in nb.items()}}
    with compat.set_mesh(tmesh):
        st, m = tr_._step_fn(0)(tr_.state, batch)
    st = jax.device_get(st)
    out.update(flat("guard/params1/", st.params))
    out.update(flat("guard/momentum1/", st.opt_state.momentum))
    out["guard/count"] = np.asarray(st.opt_state.count)
    out["guard/skipped"] = np.asarray(m["skipped_nonfinite"])
    out["guard/loss"] = np.asarray(m["loss"])
    np.savez({outp!r}, **out)
    print("JAX_FSDP_DONE")
"""
BAD = 3        # a member of pod 1 (ranks 2 and 3)
# the Trainer runs: name -> (averager, microbatch)
RUNS = {"wagma": ("wagma", None), "allreduce": ("allreduce", None),
        "wagma_microbatch": ("wagma", 2)}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("fsdp")
    rng = np.random.default_rng(0)
    rows = {}
    for e, t in enumerate(_pod_trees(rng, POD)):
        rows.update({f"pod{e}/{k}": v for k, v in t.items()})
    grads = _pod_trees(rng, DATA * POD)
    rows.update({f"grads/{k}": np.stack([g[k] for g in grads])
                 for k in TREE})
    np.savez(d / "in.npz", **rows)
    out = run_sub(JAX_SCRIPT.format(
        tree={k: (list(s), dt) for k, (s, dt) in TREE.items()},
        inp=str(d / "in.npz"), outp=str(d / "out.npz"), arch=ARCH, DATA=DATA,
        POD=POD, S=S, TAU=TAU, SEQ=SEQ, GB=GB, STEPS=STEPS, BAD=BAD,
        RUNS=RUNS),
        devices=DATA * POD, timeout=900)
    assert "JAX_FSDP_DONE" in out
    return rows, dict(np.load(d / "out.npz"))


def _pod_buffers(plan, rows):
    pods = [{k: _torch(rows[f"pod{e}/{k}"], TORCH_DT[TREE[k][1]])
             for k in TREE} for e in range(POD)]
    return plan.shard_tree({k: torch.stack([p[k] for p in pods])
                            for k in TREE})


@pytest.mark.parametrize("mode", ["overlap", "serial"])
@pytest.mark.parametrize("topo", ["flat", "hier"])
def test_average_sharded_matches_jax_every_offset(jax_runs, topo, mode):
    """The acceptance gate of tests/test_replica.py, held across packages:
    the port's pod-to-pod butterfly equals the JAX plan's on every phase
    offset bit for bit, and equals the port's replicated plan over the pod
    axis applied to the unpacked pod rows."""
    rows, res = jax_runs
    tp, _ = _plans(topo, overlap=mode == "overlap")
    bufs = _pod_buffers(tp, rows)
    before = [b.clone() for b in bufs]
    rep = plan_mod.compile_plan(tp.eff_topology, _ttree(),
                                plan_mod.AveragingConfig(group_size=S))
    assert len(tp.offsets) > 1 and tp.shard_layout.n_buckets > 1
    for off in tp.offsets:
        got = tp.average_offset(bufs, off)
        assert all(torch.equal(a, b) for a, b in zip(bufs, before))
        for b, g in enumerate(got):
            assert g.dtype == bufs[b].dtype
            assert _bits_equal(g, res[f"avg/{topo}/{mode}/{off}/{b}"]), \
                (topo, mode, off, b)
        want = rep.average_offset(tp.unshard_tree(bufs), off)
        mine = tp.unshard_tree(got)
        for k in TREE:
            assert torch.equal(mine[k], want[k]), (k, off)


def test_sync_matches_jax(jax_runs):
    rows, res = jax_runs
    for topo in ("flat", "hier"):
        tp, _ = _plans(topo)
        got = tp.sync(_pod_buffers(tp, rows))
        for b, g in enumerate(got):
            assert torch.equal(g, g[:1].expand_as(g))
            np.testing.assert_allclose(_np(g), res[f"sync/{topo}/{b}"],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pod_size", [DATA, POD])
def test_grad_shards_match_jax(jax_runs, pod_size):
    """The pod mean of the members' float32-packed gradients against the
    JAX plan's tiled ``psum_scatter`` x 1/pod_size.  Pod size 2: one fp32
    add, bit for bit.  Pod size 4: the port sums in rank order, XLA's CPU
    reduce-scatter in its own; held to 2 ulp-scale (rtol 1e-6)."""
    rows, res = jax_runs
    data, pod = pod_size, DATA * POD // pod_size
    tp, _ = _plans("hier", (data, pod))
    grads = {k: _torch(rows[f"grads/{k}"], TORCH_DT[TREE[k][1]])
             for k in TREE}
    for e in range(tp.P_eff):
        members = replica.pod_members(tp, e)
        assert members == tuple(range(e * data, (e + 1) * data))
        got = tp.grad_shards({k: v[r] for k, v in grads.items()}
                             for r in members)
        for b, g in enumerate(got):
            assert g.dtype == torch.float32
            want = res[f"grads/{pod}/{b}"][e]
            if pod_size == 2:
                assert _bits_equal(g, want), (e, b)
            else:
                np.testing.assert_allclose(g.numpy(), want, rtol=1e-6,
                                           atol=1e-7)


def _port_state(res, name, tag):
    """The run's shard buffers as a new port ReplicaState (copies: a CPU
    Trainer updates its state in place)."""
    n = len([k for k in res if k.startswith(f"{name}/params{tag}/")])
    params = tuple(torch.tensor(res[f"{name}/params{tag}/{b}"])
                   for b in range(n))
    mom = tuple(torch.tensor(res[f"{name}/momentum{tag}/{b}"])
                for b in range(n))
    return ReplicaState(params, SGDState(mom, torch.zeros(POD,
                                                          dtype=torch.int32)))


def _trainer(averager, state, microbatch=None):
    cfg = get_config(ARCH, smoke=True).variant(dtype="float32")
    kw = dict(group_size=S, tau=TAU) if averager == "wagma" else {}
    kw["microbatch"] = microbatch
    topo = plan_mod.Topology.hierarchical(("data", "pod"), (DATA, POD),
                                          dcn_axes=("pod",))
    return Trainer(cfg, DATA, pod_axis=POD, device="cpu", averager=averager,
                   seq_len=SEQ, global_batch=GB, seed=0, topology=topo,
                   sharding="fsdp", init_state=state, **kw)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(RUNS))
def test_fsdp_trainer_matches_jax_trainer(jax_runs, name, one_thread):
    """Six steps of ``Trainer(sharding="fsdp")`` from the JAX run's initial
    shard buffers: losses, every buffer of params and momentum (to RTOL of
    its largest magnitude), counts, step and phase; under ``wagma``,
    ``allreduce`` and ``wagma`` with two microbatches a member."""
    _, res = jax_runs
    averager, microbatch = RUNS[name]
    state = _port_state(res, name, 0)
    trainer = _trainer(averager, state, microbatch)
    plan = trainer.plan()
    assert plan.sharding == FSDP and (plan.P, plan.P_eff) == (DATA * POD,
                                                              POD)
    assert len(state.params) == plan.shard_layout.n_buckets
    assert [tuple(b.shape) for b in state.params] == \
        [(POD, n) for n in plan.shard_layout.bucket_sizes]
    losses = [trainer.step_once(t) for t in range(STEPS)]
    np.testing.assert_allclose(losses, res[f"{name}/losses"], rtol=RTOL,
                               atol=RTOL)
    assert (trainer.state.step, trainer.state.phase) == \
        tuple(res[f"{name}/step_phase"])
    assert trainer.state.opt_state.count.tolist() == \
        res[f"{name}/count"].tolist()
    assert trainer.skipped_nonfinite == 0 == float(res[f"{name}/skipped"])
    want = _port_state(res, name, 1)
    for tag, got, exp in (("params", trainer.state.params, want.params),
                          ("momentum", trainer.state.opt_state.momentum,
                           want.opt_state.momentum)):
        for g, w in zip(got, exp):
            scale = float(w.abs().max()) or 1.0
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                       atol=RTOL * scale, err_msg=tag)
    if averager == "wagma":
        # the step ended on a group average: the groups' pods agree
        for b in trainer.state.params:
            assert not torch.equal(b[0], b[1]) or not torch.equal(b[0], b[2])
        cons = trainer.consolidated()
        assert set(cons) == set(tfm.param_specs(trainer.cfg))


def test_pod_nonfinite_guard_matches_jax(jax_runs, one_thread):
    """A NaN in one member's batch rows poisons its pod's mean gradient:
    that pod alone skips (params, moments and count exactly as before),
    every other pod updates, as the JAX step's ``pmin`` over the shard
    axis decides."""
    _, res = jax_runs
    trainer = _trainer("wagma", _port_state(res, "wagma", 0))
    before = [b.clone() for b in trainer.state.params]
    seen = []
    comm = trainer.averager.comm
    trainer.averager.comm = lambda tree, phase: (seen.append(
        [b.clone() for b in tree]), comm(tree, phase))[1]
    batch = trainer._put_batch(0)
    b = GB // (DATA * POD)
    batch["mask"] = torch.ones_like(batch["labels"], dtype=torch.float32)
    batch["mask"][BAD * b:(BAD + 1) * b] = float("nan")
    trainer.state, metrics = trainer._step_fn(0)(trainer.state, batch)
    bad_pod = BAD // DATA
    assert float(metrics["skipped_nonfinite"]) == \
        pytest.approx(float(res["guard/skipped"])) == DATA / (DATA * POD)
    assert trainer.state.opt_state.count.tolist() == \
        res["guard/count"].tolist() == [0 if e == bad_pod else 1
                                        for e in range(POD)]
    for pre, old in zip(seen[0], before):
        assert torch.equal(pre[bad_pod], old[bad_pod])
        assert torch.isfinite(pre).all()
        assert not torch.equal(pre[1 - bad_pod], old[1 - bad_pod])
    for b_, (g, w) in enumerate(zip(trainer.state.params,
                                    _port_state(res, "guard", 1).params)):
        scale = float(w.abs().max()) or 1.0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=RTOL,
                                   atol=RTOL * scale)
    assert all(torch.equal(m[bad_pod], torch.zeros_like(m[bad_pod]))
               for m in trainer.state.opt_state.momentum)
