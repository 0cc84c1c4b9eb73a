"""The port's compiled averaging plan against the JAX package's.

The stacked realisation (replicas as rows, the exchange a gather along dim
0, K1/K2 combines through their plain versions on the CPU) must give the
JAX plan's ``average_offset`` under ``shard_map`` on 8 host devices bit for
bit, on every phase offset, fused (overlapped and serial, against the JAX
plan's Pallas and plain-jnp combines) and per leaf; the averaging-matrix
oracle to 1e-5; and ``sync``
the JAX ``pmean`` to 1e-6.  The JAX side runs once per module in a
subprocess (tests/subproc.py) and its results are shared by the tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subproc import run_sub

from repro.configs import get_config as jax_config
from repro.core import group_allreduce as jga
from repro.core import plan as jplan
from repro.core.wagma import WagmaAverager as JWagma
from repro.core.wagma import WagmaConfig as JConfig
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.core import baselines, bucketing
from repro_torch.core import group_allreduce as ga
from repro_torch.core import plan as tp
from repro_torch.core import tree as tr
from repro_torch.core.replica import ShardingPolicy
from repro_torch.core.wagma import WagmaAverager, WagmaConfig
from repro_torch.models import transformer as tfm

P, S = 8, 4
SMALL = 1024          # bytes: several buckets, so K2 gets multi-pair batches
# name -> (AveragingConfig kwargs shared by both packages, JAX-only kwargs)
VARIANTS = {
    "flat_overlap": (dict(bucket_bytes=SMALL), {}),
    "flat_serial": (dict(bucket_bytes=SMALL, overlap=False), {}),
    # the port's K1/K2 route against the JAX plan's plain-jnp combine
    "flat_torch_combine": (dict(bucket_bytes=SMALL), dict(use_pallas=False)),
    "flat_default_budget": (dict(), {}),
    "per_leaf": (dict(fused=False), {}),
    # no accumulation dtype: bf16 buckets combine in bf16 storage per stage
    "storage_dtype": (dict(bucket_bytes=SMALL, average_dtype=None), {}),
    "storage_dtype_serial": (dict(bucket_bytes=SMALL, average_dtype=None,
                                  overlap=False), {}),
}
LEAVES = {"emb": (33, 7), "w": (130,), "s": (), "h": (3, 5), "e": (0, 4),
          "m": (40, 9), "v": (300,)}
BF16 = ("h",)


def _inputs():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal((P,) + shape).astype(np.float32)
            for k, shape in LEAVES.items()}


def _torch_tree(arrs):
    return {k: torch.from_numpy(a).to(torch.bfloat16 if k in BF16
                                      else torch.float32)
            for k, a in arrs.items()}


JAX_BODY = """
    import json
    from repro.core import grouping
    from repro.core import group_allreduce as ga
    from repro.core import plan as plan_mod
    arrs = dict(np.load({inp!r}))
    variants = json.loads({variants!r})
    tree = {{k: jnp.asarray(a, jnp.bfloat16 if k in {bf16!r} else jnp.float32)
            for k, a in arrs.items()}}
    local = jax.tree.map(lambda a: a[0], tree)
    mesh = jax.make_mesh((2, 4), ("pod", "data"))
    names, sizes = ga.dp_axis_layout(("pod", "data"), dict(pod=2, data=4),
                                     ("pod", "data"))
    out = {{}}
    for name, kw in variants.items():
        topo = plan_mod.Topology.flat(names, sizes)
        pl = plan_mod.compile_plan(topo, local, plan_mod.AveragingConfig(
            group_size={S}, **kw))
        for off in pl.offsets:
            f = compat.shard_map(
                lambda tr, pl=pl, off=off: pl.average_offset(tr, off),
                mesh=mesh, in_specs=P(("pod", "data")),
                out_specs=P(("pod", "data")), axis_names={{"pod", "data"}})
            res = jax.jit(f)(tree)
            for k, v in res.items():
                out[f"{{name}}/{{off}}/{{k}}"] = np.asarray(v, np.float32)
        if name == "flat_default_budget":
            f = compat.shard_map(lambda tr, pl=pl: pl.sync(tr), mesh=mesh,
                                 in_specs=P(("pod", "data")),
                                 out_specs=P(("pod", "data")),
                                 axis_names={{"pod", "data"}})
            for k, v in jax.jit(f)(tree).items():
                out[f"sync/{{k}}"] = np.asarray(v, np.float32)
    np.savez({outp!r}, **out)
    print("JAX_DONE", len(out))
"""


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    import json
    d = tmp_path_factory.mktemp("plan")
    inp, outp = str(d / "in.npz"), str(d / "out.npz")
    np.savez(inp, **_inputs())
    variants = {k: dict(kw, **jax_kw)
                for k, (kw, jax_kw) in VARIANTS.items()}
    out = run_sub(JAX_BODY.format(inp=inp, outp=outp, S=S, bf16=BF16,
                                  variants=json.dumps(variants)))
    assert "JAX_DONE" in out
    return dict(np.load(outp))


def _plan(kw):
    topo = tp.Topology.flat(("data", "pod"), (4, 2))
    tree = _torch_tree(_inputs())
    return tp.compile_plan(topo, tr.struct(tree, drop=1),
                           tp.AveragingConfig(group_size=S, **kw)), tree


@pytest.mark.parametrize("name", list(VARIANTS))
def test_average_offset_bit_exact_vs_jax_every_offset(name, jax_results):
    plan, tree = _plan(VARIANTS[name][0])
    assert plan.offsets == (0, 2, 1)
    if name in ("flat_overlap", "flat_torch_combine"):
        assert plan.class_layout(0).n_buckets >= 3
    before = {k: v.clone() for k, v in tree.items()}
    for off in plan.offsets:
        got = plan.average_offset(tree, off)
        for k in tree:
            assert got[k].dtype == tree[k].dtype
            assert got[k].shape == tree[k].shape
            want = jax_results[f"{name}/{off}/{k}"]
            np.testing.assert_array_equal(
                got[k].float().numpy(), want,
                err_msg=f"{name} offset {off} leaf {k}")
    for k in tree:                                 # the input is untouched
        assert torch.equal(tree[k], before[k])


def test_average_matches_averaging_matrix_oracle():
    plan, tree = _plan(dict(bucket_bytes=SMALL))
    for t in range(3):
        got = plan.average(tree, plan.offsets.index(
            plan.offsets[t % plan.n_phases]))
        oracle = plan.average_stacked(tree, t=t)
        jor = jga.group_average_stacked(
            {k: jnp.asarray(v.float().numpy()) for k, v in tree.items()},
            P=P, S=S, t=t)
        for k in tree:
            tol = 2e-2 if k in BF16 else 1e-5
            np.testing.assert_allclose(got[k].float().numpy(),
                                       oracle[k].float().numpy(),
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(oracle[k].float().numpy(),
                                       np.asarray(jor[k], np.float32),
                                       rtol=tol, atol=tol)


def test_sync_matches_jax_pmean(jax_results):
    for fused in (True, False):
        plan, tree = _plan(dict(fused=fused))
        got = plan.sync(tree)
        sim = plan.sync_stacked(tree)
        for k in tree:
            tol = 1e-2 if k in BF16 else 1e-6
            np.testing.assert_allclose(got[k].float().numpy(),
                                       jax_results[f"sync/{k}"],
                                       rtol=tol, atol=tol)
            np.testing.assert_allclose(got[k].float().numpy(),
                                       sim[k].float().numpy(),
                                       rtol=tol, atol=tol)
            assert torch.equal(got[k], got[k][:1].expand_as(got[k]))


def test_butterfly_exchange_is_the_xor_partner():
    buf = torch.arange(P * 3, dtype=torch.float32).reshape(P, 3)
    for bit in range(3):
        recv = tp.butterfly_exchange(buf, bit)
        for i in range(P):
            assert torch.equal(recv[i], buf[i ^ (1 << bit)])
    with pytest.raises(ValueError):
        tp.butterfly_exchange(buf, 3)


def test_static_plan_matches_jax():
    """Runs, budgets, layouts and the summary of the port's plan are the
    JAX plan's, under the default link and a pinned budget."""
    tree = _torch_tree(_inputs())
    jlocal = {k: jax.ShapeDtypeStruct(
        LEAVES[k], jnp.bfloat16 if k in BF16 else jnp.float32) for k in tree}
    pinned = dict(bucket_bytes=2 * SMALL)
    for topo, jtopo in (
            (tp.Topology.flat(("data", "pod"), (4, 2)),
             jplan.Topology.flat(("data", "pod"), (4, 2))),
            (tp.Topology.flat(("data", "pod"), (4, 2),
                              link=tp.LinkClass("pinned", **pinned)),
             jplan.Topology.flat(("data", "pod"), (4, 2),
                                 link=jplan.LinkClass("pinned", **pinned)))):
        for kw in ({}, {"bucket_bytes": SMALL}):
            plan = tp.compile_plan(topo, tr.struct(tree, drop=1),
                                   tp.AveragingConfig(group_size=S, **kw))
            jp = jplan.compile_plan(jtopo, jlocal,
                                    jplan.AveragingConfig(group_size=S, **kw))
            assert plan.offsets == jp.offsets and plan.S == jp.S
            assert plan.class_bucket_bytes == jp.class_bucket_bytes
            assert plan.payload_bytes == jp.payload_bytes
            for off in plan.offsets:
                assert [(r.class_index, r.bits)
                        for r in plan.runs_for_offset(off)] == \
                    [(r.class_index, r.bits) for r in jp.runs_for_offset(off)]
                mine = plan.butterfly_summary(off)
                theirs = jp.butterfly_summary(off)
                for a, b in zip(mine, theirs):
                    assert a["exchanges"] == b["ppermutes"]
                    assert {k: a[k] for k in ("link", "bits", "axes",
                                              "stages", "bucket_bytes",
                                              "n_buckets")} == \
                        {k: b[k] for k in ("link", "bits", "axes", "stages",
                                           "bucket_bytes", "n_buckets")}
            assert "phase 2 (offset 1)" in plan.describe()
    assert tp.compile_plan(topo, tr.struct(tree, drop=1),
                           tp.AveragingConfig(group_size=S)) is \
        tp.compile_plan(topo, tr.struct(tree, drop=1),
                        tp.AveragingConfig(group_size=S))


def test_slice_budget_is_64mib_with_jax_bucket_count():
    """tinyllama-1.1b at full width and 6 layers: the cost model picks the
    JAX budget (64 MiB) and the layout has the JAX bucket count."""
    cfg = get_config("tinyllama-1.1b").variant(n_layers=6)
    local = tfm.param_specs(cfg)
    plan = tp.compile_plan(tp.Topology.flat(("data",), (8,)), local,
                           tp.AveragingConfig(group_size=4, tau=5))
    jshapes = jax.eval_shape(
        jax_build(jax_config("tinyllama-1.1b").variant(n_layers=6)).init,
        jax.random.PRNGKey(0))
    jp = jplan.compile_plan(jplan.Topology.flat(("data",), (8,)), jshapes,
                            jplan.AveragingConfig(group_size=4, tau=5))
    assert plan.class_bucket_bytes == jp.class_bucket_bytes == {0: 64 << 20}
    assert plan.class_layout(0).n_buckets == jp.class_layout(0).n_buckets
    # stacked layer leaves: w1/w2/w3 of 6 layers are 277 MB each in
    # float32, so several buckets hold one oversize leaf
    assert plan.class_layout(0).n_buckets == 10
    for payload in (1, 1 << 20, 1580 << 20, 6 << 30):
        # the JAX package's default, ICI and DCN constants
        for jlink in (jplan.DEFAULT_LINK, jplan.ICI, jplan.DCN):
            link = tp.LinkClass(jlink.name, jlink.alpha, jlink.beta,
                                jlink.gamma)
            assert tp.choose_class_bucket_bytes(payload, link) == \
                jplan.choose_class_bucket_bytes(payload, jlink)


def test_averager_bookkeeping_matches_jax():
    cfg, jcfg = WagmaConfig(group_size=4, tau=5), JConfig(group_size=4, tau=5)
    avg = WagmaAverager(("data",), (8,), cfg)
    javg = JWagma(("data",), (8,), jcfg)
    assert avg.n_phases == javg.n_phases == 3
    for t in range(12):
        assert avg.phase_for_step(t) == javg.phase_for_step(t)
        assert avg.sync_due(t) == javg.sync_due(t)
    fixed = WagmaAverager(("data",), (8,), WagmaConfig(
        group_size=4, dynamic_groups=False))
    assert fixed.offsets == (0,) and fixed.phase_for_step(5) == 0
    for P_, S_ in ((8, 4), (64, 8), (16, 2)):
        for t in range(4):
            np.testing.assert_array_equal(ga.averaging_matrix(P_, S_, t),
                                          jga.averaging_matrix(P_, S_, t))
        assert ga.wagma_step_time(1 << 26, P_, S_, tau=5, n_buckets=3,
                                  gamma=1e-12, overlap=True) == \
            jga.wagma_step_time(1 << 26, P_, S_, tau=5, n_buckets=3,
                                gamma=1e-12, overlap=True)
    assert ga.dp_axis_layout(("pod", "data", "model"),
                             dict(pod=2, data=4, model=1),
                             ("pod", "data")) == (("data", "pod"), (4, 2))


def test_unported_paths_name_their_slice():
    # FSDP within a pod is ported (tests/test_torch_fsdp.py), and its
    # layer-streamed layout (tests/test_torch_streaming.py)
    assert ShardingPolicy.fsdp_within_pod("data").is_sharded
    streamed = ShardingPolicy.fsdp_within_pod("data", streamed=True)
    assert streamed.is_sharded and streamed.streamed
    assert streamed.describe() == "fsdp_within_pod(shard_axis='data', streamed)"
    assert baselines.make_averager("dpsgd", ("data",), (8,)).n_phases == 1
    with pytest.raises(ValueError):
        baselines.make_averager("nope", ("data",), (8,))
    avg = baselines.make_averager("wagma", ("data",), (8,), group_size=4)
    assert isinstance(avg, WagmaAverager) and avg.S == 4
    with pytest.raises(ValueError):
        WagmaAverager(("data",), (4,), WagmaConfig(group_size=8))
    bucketing.clear_layout_cache()
