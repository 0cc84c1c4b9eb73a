"""The port's baseline averagers (``core/baselines.py``) and ``plan.mix``
against the JAX package's.

Each of the six baselines' ``comm`` on every phase and its ``sync``, fused
(overlapped and serial, buckets small enough that the tree spans several)
and per leaf, on a stacked P = 8 tree of mixed leaves (float32 and
bfloat16, an empty leaf, ragged shapes), must give the JAX averager's
result under ``shard_map`` on an 8-device mesh with Auto axes (ROADMAP.md
F1): bit for bit for the ring, pair and butterfly mixes (IEEE adds in the
same order and one product with the divisor's float32 reciprocal, which is
what XLA compiles the reference's division by a constant into), to 1e-6
relative for the ``pmean`` mixes (the backend picks the order of the
sum).  The ring's direction is checked on
rows that hold their own index.  Step bookkeeping and ``mixing_matrix``
must be equal.  The JAX side runs once, in a subprocess.
"""

import json

import numpy as np
import pytest
import torch

from subproc import run_sub

from repro.core import baselines as jbaselines
from repro_torch.core import baselines, bucketing
from repro_torch.core import plan as tp
from repro_torch.core.wagma import WagmaAverager

P = 8
SMALL = 1024          # bytes: several buckets a tree
NAMES = ("allreduce", "local_sgd", "dpsgd", "sgp", "adpsgd", "eager_sgd")
PMEAN = ("allreduce", "eager_sgd")
# name -> the averager kwargs shared by both packages
VARIANTS = {
    "fused_overlap": dict(bucket_bytes=SMALL),
    "fused_serial": dict(bucket_bytes=SMALL, overlap=False),
    "fused_default_budget": dict(),
    "per_leaf": dict(fused=False),
}
LEAVES = {"emb": (33, 7), "w": (130,), "s": (), "h": (3, 5), "e": (0, 4),
          "m": (40, 9), "v": (300,), "g": (17,)}
BF16 = ("h", "g")


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
    from jax.sharding import AxisType
    from repro.core import baselines
    arrs = dict(np.load({inp!r}))
    tree = {{k: jnp.asarray(a, jnp.bfloat16 if k in {bf16!r} else jnp.float32)
            for k, a in arrs.items()}}
    mesh = jax.make_mesh(({P},), ("data",), axis_types=(AxisType.Auto,))
    spec = P("data")
    out = {{}}

    def run(fn, arg):
        f = compat.shard_map(fn, mesh=mesh, in_specs=spec, out_specs=spec,
                             axis_names={{"data"}})
        return jax.jit(f)(arg)

    for name in {names!r}:
        for var, kw in json.loads({variants!r}).items():
            avg = baselines.make_averager(name, ("data",), ({P},), **kw)
            for ph in range(avg.n_phases):
                res = run(lambda t, avg=avg, ph=ph: avg.comm(t, ph), tree)
                for k, v in res.items():
                    out[f"{{name}}/{{var}}/comm{{ph}}/{{k}}"] = np.asarray(
                        v, np.float32)
            for k, v in run(avg.sync, tree).items():
                out[f"{{name}}/{{var}}/sync/{{k}}"] = np.asarray(v,
                                                                np.float32)
    # the ring's direction: rows that hold their own index
    rows = jnp.arange({P}, dtype=jnp.float32)[:, None]
    fwd = [(i, (i + 1) % {P}) for i in range({P})]
    out["ring/fwd"] = np.asarray(run(
        lambda x: jax.lax.ppermute(x, "data", fwd), rows))
    np.savez({outp!r}, **out)
    print("JAX_DONE", len(out))
"""


@pytest.fixture(scope="module")
def jax_results(tmp_path_factory):
    d = tmp_path_factory.mktemp("baselines")
    inp, outp = str(d / "in.npz"), str(d / "out.npz")
    np.savez(inp, **_inputs())
    out = run_sub(JAX_BODY.format(inp=inp, outp=outp, P=P, bf16=BF16,
                                  names=NAMES,
                                  variants=json.dumps(VARIANTS)))
    assert "JAX_DONE" in out
    return dict(np.load(outp))


def _check(got, tree, res, key, exact):
    for k in tree:
        assert got[k].dtype == tree[k].dtype, k
        assert got[k].shape == tree[k].shape, k
        want = res[f"{key}/{k}"]
        have = got[k].float().numpy()
        if exact:
            np.testing.assert_array_equal(have, want, err_msg=f"{key}/{k}")
        else:
            np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"{key}/{k}")


@pytest.mark.parametrize("var", list(VARIANTS))
@pytest.mark.parametrize("name", NAMES)
def test_comm_and_sync_match_jax(name, var, jax_results):
    avg = baselines.make_averager(name, ("data",), (P,), **VARIANTS[var])
    tree = _torch_tree(_inputs())
    before = {k: v.clone() for k, v in tree.items()}
    if var == "fused_overlap":
        plan = avg.plan_for(tree)
        assert bucketing.layout_for(
            plan.work_struct, max_bucket_bytes=plan.mix_bucket_bytes()
        ).n_buckets >= 3
    for ph in range(avg.n_phases):
        got = avg.comm(tree, ph)
        _check(got, tree, jax_results, f"{name}/{var}/comm{ph}",
               exact=name not in PMEAN)
    _check(avg.sync(tree), tree, jax_results, f"{name}/{var}/sync",
           exact=False)
    for k in tree:                      # the input tree is not modified
        assert torch.equal(tree[k], before[k])


def test_ring_direction_matches_ppermute(jax_results):
    rows = torch.arange(P, dtype=torch.float32)[:, None]
    np.testing.assert_array_equal(tp.ring_shift(rows, 1, P).numpy(),
                                  jax_results["ring/fwd"])
    # row j receives row j - 1 (left) and row j + 1 (right)
    assert tp.ring_shift(rows, 1, P)[:, 0].tolist() == \
        [(j - 1) % P for j in range(P)]
    assert tp.ring_shift(rows, -1, P)[:, 0].tolist() == \
        [(j + 1) % P for j in range(P)]
    # two rings of 4 on 8 rows (the minor axis of a 4 x 2 layout)
    assert tp.ring_shift(rows, 1, 4)[:, 0].tolist() == \
        [3, 0, 1, 2, 7, 4, 5, 6]
    # D-PSGD's combine on one-hot rows: row j takes a third of j-1, j, j+1
    eye = {"w": torch.eye(P)}
    got = baselines.make_averager("dpsgd", ("data",), (P,)).comm(eye, 0)["w"]
    want = torch.from_numpy(baselines.mixing_matrix("dpsgd", P, 0))
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_step_bookkeeping_matches_jax(name):
    kw = {"sync_period": 5} if name == "local_sgd" else {}
    for n in (8, 16):
        got = baselines.make_averager(name, ("data",), (n,), **kw)
        want = jbaselines.make_averager(name, ("data",), (n,), **kw)
        assert (got.n_phases, got.grad_comm, got.P, got.P_eff) == \
            (want.n_phases, want.grad_comm, want.P, want.P_eff)
        assert got.comm_axis_names == want.comm_axis_names
        for t in range(40):
            assert got.phase_for_step(t) == want.phase_for_step(t)
            assert got.sync_due(t) == want.sync_due(t)


@pytest.mark.parametrize("name", ("wagma",) + NAMES)
def test_mixing_matrix_equal(name):
    for n in (8, 16):
        for t in range(10):
            kw = dict(S=4, sync_period=5) if name in ("wagma",
                                                      "local_sgd") else {}
            a = baselines.mixing_matrix(name, n, t, **kw)
            b = jbaselines.mixing_matrix(name, n, t, **kw)
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, n, t)
            np.testing.assert_allclose(a.sum(1), 1.0, rtol=1e-6)


def test_make_averager_builds_every_name():
    assert baselines.AVERAGERS == ("wagma",) + NAMES
    for name in baselines.AVERAGERS:
        avg = baselines.make_averager(name, ("data",), (8,))
        assert avg.name == name
    assert isinstance(baselines.make_averager("WAGMA", ("data",), (8,)),
                      WagmaAverager)
    with pytest.raises(ValueError):
        baselines.make_averager("nope", ("data",), (8,))
    with pytest.raises(ValueError):
        baselines.make_averager("dpsgd", ("data",), (8,),
                                topology=tp.Topology.flat(("data",), (4,)))


def test_mix_bucket_bytes_matches_jax():
    """The budget of a one-round mix: the configured override, or the
    per-class sweep on the slowest link its bits ride (every class for a
    global collective), as the JAX plan picks it."""
    import jax.numpy as jnp
    from repro.core import plan as jplan
    from repro_torch.core import tree as tr

    local = {k: np.zeros(shape, np.float32) for k, shape in LEAVES.items()}
    jtree = {k: jnp.asarray(a) for k, a in local.items()}
    ttree = {k: torch.from_numpy(a) for k, a in local.items()}
    for kw in ({}, {"bucket_bytes": SMALL}, {"bucket_bytes": None},
               {"bucket_bytes": None, "overlap": False}):
        jp = jplan.compile_plan(jplan.Topology.flat(("data",), (P,)), jtree,
                                jplan.AveragingConfig(**kw))
        p = tp.compile_plan(tp.Topology.flat(("data",), (P,)),
                            tr.struct(ttree), tp.AveragingConfig(**kw))
        for bits in ((), (0,), (1, 2)):
            assert p.mix_bucket_bytes(bits) == jp.mix_bucket_bytes(bits)
