"""The port's train-to-serve handoff (``repro_torch/serve/handoff.py``,
``replica.consolidate_state``, ``Trainer.consolidated``) against the JAX
package's.

A post-sync replicated state (every row the same weights ``p0``) is handed
off as ``p0`` bit for bit and as the JAX ``serving_weights_from_state``;
rows that differ consolidate bit-identically to JAX in bfloat16 (the sum of
a few bf16 rows is exact in float32 in any order) and within 1e-6 relative
in float32 (the backends order the sum).  Replicated checkpoints cross
both ways between the packages' readers.  FSDP states and checkpoints,
gather-all and layer-streamed, hand off as the JAX package's.
``Trainer.consolidated`` matches the JAX ``Trainer.consolidated`` (Auto-typed host mesh, ROADMAP.md F1) to the
trainer tests' 1e-5, and over four gloo ranks rank 0's equals the stacked
``Trainer``'s bit for bit while the other ranks get ``None``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rank_runs
from jax_trainer_runs import one_torch_thread  # noqa: F401
from subproc import run_sub

from repro.checkpoint import ckpt as jckpt
from repro.configs import get_config as jax_config
from repro.core import replica as jreplica
from repro.core.plan import AveragingConfig as JConfig
from repro.core.plan import Topology as JTopology
from repro.core.plan import compile_plan as jcompile_plan
from repro.core.replica import ReplicaState as JState
from repro.core.replica import ShardingPolicy as JPolicy
from repro.models.registry import build_model as jax_build
from repro.optim import sgd as jax_sgd
from repro.serve import handoff as jhandoff
from repro_torch.checkpoint import load_replica_state, save_replica_state
from repro_torch.configs import get_config
from repro_torch.core import tree as tr
from repro_torch.core.replica import ReplicaState, consolidate_state
from repro_torch.launch.train import Trainer
from repro_torch.models.convert import params_from_jax, replica_state_from_jax
from repro_torch.models.registry import build_model
from repro_torch.serve import (serving_weights_from_checkpoint,
                               serving_weights_from_state)

P = 4
ARCH = "qwen3-0.6b"
F32_RTOL, TRAINER_RTOL = 1e-6, 1e-5


def _models(dtype):
    jcfg = jax_config(ARCH, smoke=True).variant(dtype=dtype)
    cfg = get_config(ARCH, smoke=True).variant(dtype=dtype)
    return jcfg, jax_build(jcfg), cfg, build_model(cfg, device="cpu")


def _jax_state(jm, rows_differ: bool):
    """A (P, ...) JAX ReplicaState: every row ``p0``, or row r ``p0`` plus
    r times a small perturbation (rows that differ)."""
    p0 = jm.init(jax.random.PRNGKey(0))
    stacked = jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (P,) + a.shape), p0)
    if rows_differ:
        keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))
        stacked = jax.tree.map(
            lambda a: (a.astype(jnp.float32) + 0.01 * jnp.arange(P).reshape(
                (P,) + (1,) * (a.ndim - 1)) * jax.random.normal(
                    next(keys), a.shape)).astype(a.dtype), stacked)
    opt = jax.vmap(jax_sgd(0.1, momentum=0.9).init)(stacked)
    return p0, JState.create(stacked, opt, step=7, phase=2)


def _port_state(cfg, jstate):
    return replica_state_from_jax(cfg, jax.device_get(jstate), "cpu")


def _as_numpy(t):
    return t.float().numpy()


def _assert_equal_to_jax(got, want):
    """Port tree == JAX tree, element for element (bf16 widened to f32
    exactly on both sides)."""
    g_leaves, w_leaves = tr.tree_leaves(got), jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w in zip(g_leaves, w_leaves):
        assert np.array_equal(_as_numpy(g), np.asarray(w, np.float32))


@pytest.fixture(scope="module")
def post_sync():
    jcfg, jm, cfg, model = _models("float32")
    p0, jstate = _jax_state(jm, rows_differ=False)
    return jm, p0, jstate, cfg, model, _port_state(cfg, jstate)


def test_post_sync_state_hands_off_p0_bit_for_bit(post_sync):
    _, p0, jstate, cfg, _, state = post_sync
    weights = serving_weights_from_state(state)
    want_p0 = params_from_jax(cfg, jax.tree.map(np.asarray, p0), "cpu")
    for g, w in zip(tr.tree_leaves(weights), tr.tree_leaves(want_p0)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    _assert_equal_to_jax(weights, jhandoff.serving_weights_from_state(jstate))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_differing_rows_consolidate_as_jax(dtype):
    _, jm, cfg, _ = _models(dtype)
    _, jstate = _jax_state(jm, rows_differ=True)
    state = _port_state(cfg, jstate)
    rows = tr.tree_leaves(state.params)
    assert any(not torch.equal(a[0], a[1]) for a in rows)
    got = serving_weights_from_state(state)
    want = jhandoff.serving_weights_from_state(jstate)
    if dtype == "bfloat16":
        _assert_equal_to_jax(got, want)
        return
    for g, w in zip(tr.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_RTOL,
                                   atol=F32_RTOL * float(np.abs(w).max()))


def test_handed_off_weights_serve_as_p0(post_sync):
    _, p0, _, cfg, model, state = post_sync
    weights = serving_weights_from_state(state)
    want_p0 = params_from_jax(cfg, jax.tree.map(np.asarray, p0), "cpu")
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 6)), dtype=torch.int64)
    la, ca = model.prefill(want_p0, {"tokens": prompt}, 8)
    lb, cb = model.prefill(weights, {"tokens": prompt}, 8)
    assert torch.equal(la, lb)
    for a, b in zip(tr.tree_leaves(ca), tr.tree_leaves(cb)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_checkpoint_handoff_crosses_both_ways(dtype, tmp_path):
    """A replicated checkpoint written by either package is read by both
    packages' ``serving_weights_from_checkpoint`` to the same weights."""
    _, jm, cfg, _ = _models(dtype)
    _, jstate = _jax_state(jm, rows_differ=True)
    state = _port_state(cfg, jstate)
    jtemplate = jax.eval_shape(lambda: jstate)
    want = jhandoff.serving_weights_from_state(jstate)

    jdir = str(tmp_path / "from_jax")
    jckpt.save_replica_state(jdir, jax.device_get(jstate))
    got = serving_weights_from_checkpoint(jdir, state)
    _assert_equal_to_jax(got, jhandoff.serving_weights_from_checkpoint(
        jdir, jtemplate))
    _assert_equal_to_jax(got, want)

    tdir = str(tmp_path / "from_port")
    save_replica_state(tdir, state)
    _assert_equal_to_jax(serving_weights_from_checkpoint(tdir, state),
                         jhandoff.serving_weights_from_checkpoint(
                             tdir, jtemplate))
    for g, w in zip(tr.tree_leaves(serving_weights_from_checkpoint(
            tdir, state)), tr.tree_leaves(serving_weights_from_state(state))):
        assert g.dtype == w.dtype and torch.equal(g, w)


def test_sharded_and_streamed_branches_name_the_fsdp_slice(post_sync,
                                                           tmp_path):
    """Both FSDP branches (ported): a JAX-written FSDP checkpoint, gather-
    all or layer-streamed, hands off through the port's plan of the same
    policy (and, streamed, its model) the weights the JAX package hands
    off, bit for bit (p0: every pod holds it)."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import replica
    from repro_torch.models.convert import PARAM_SPECS
    jm, p0, jstate, cfg, model, state = post_sync
    topo = JTopology.hierarchical(("data", "pod"), (2, 2))
    struct = jax.eval_shape(lambda: p0)
    for streamed in (False, True):
        specs = PARAM_SPECS[cfg.family](cfg)
        if streamed:
            specs = model.layered.split(specs)
        tplan = plan_mod.compile_plan(
            plan_mod.Topology.hierarchical(("data", "pod"), (2, 2)), specs,
            plan_mod.AveragingConfig(group_size=2),
            replica.ShardingPolicy.fsdp_within_pod("data", streamed=streamed))
        pol = JPolicy.fsdp_within_pod("data", streamed=streamed)
        tree = jax.eval_shape(jm.layered.split, p0) if streamed else struct
        plan = jcompile_plan(topo, tree, JConfig(group_size=2), pol)
        src = (jreplica.split_layered_state(jstate, jm.layered) if streamed
               else jstate)
        fsdp = jreplica.replicated_to_fsdp_state(src, plan)
        path = str(tmp_path / f"fsdp{int(streamed)}")
        jckpt.save_replica_state(path, fsdp, sharding=pol)
        template = replica.sharded_state_template(tplan, state.opt_state)
        got = serving_weights_from_checkpoint(path, template, plan=tplan,
                                              model=model)
        _assert_equal_to_jax(got, jhandoff.serving_weights_from_checkpoint(
            path, jax.eval_shape(lambda: fsdp), plan=plan, model=jm))
        _assert_equal_to_jax(got, p0)
        rep = (replica.split_layered_state(state, model.layered)
               if streamed else state)
        t_fsdp = replica.replicated_to_fsdp_state(rep, tplan)
        _assert_equal_to_jax(
            serving_weights_from_state(t_fsdp, plan=tplan, model=model),
            jhandoff.serving_weights_from_state(fsdp, plan=plan, model=jm))
    buffers = ReplicaState(tuple(tr.tree_leaves(state.params)),
                           state.opt_state)
    with pytest.raises(ValueError, match="sharded plan"):
        consolidate_state(buffers)


# ---------------------------------------------------------------------------
# Trainer.consolidated: against the JAX Trainer, and over gloo ranks
# ---------------------------------------------------------------------------

T_ARCH, SEQ, GB, STEPS, TAU = "tinyllama-1.1b", 16, 8, 3, 5

JAX_RUN = """
    from jax.sharding import AxisType
    from repro.checkpoint import save_replica_state
    from repro.configs import get_config
    from repro.launch.train import Trainer

    cfg = get_config({arch!r}, smoke=True).variant(dtype="float32")
    mesh = jax.make_mesh(({P}, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tr = Trainer(cfg, mesh, seq_len={seq}, global_batch={gb}, seed=0,
                 tau={tau})
    save_replica_state({out!r} + "/init", jax.device_get(tr.state))
    with compat.set_mesh(mesh):
        for t in range({steps}):
            tr.step_once(t)
    cons = tr.consolidated()
    np.savez({out!r} + "/consolidated.npz", **{{
        "/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_leaves_with_path(cons)}})
    print("JAX_RUN_DONE")
"""


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("consolidated"))
    res = run_sub(JAX_RUN.format(arch=T_ARCH, P=P, seq=SEQ, gb=GB, tau=TAU,
                                 steps=STEPS, out=out), devices=P,
                  timeout=600)
    assert "JAX_RUN_DONE" in res
    cfg = get_config(T_ARCH, smoke=True).variant(dtype="float32")
    kw = dict(averager="wagma", tau=TAU, seq_len=SEQ, global_batch=GB,
              seed=0)
    init = os.path.join(out, "init")
    trainer = Trainer(cfg, P, device="cpu", init_state=load_replica_state(
        init, rank_runs.state_template(cfg, P, {})), **kw)
    for t in range(STEPS):
        trainer.step_once(t)
    return out, cfg, kw, trainer


def test_trainer_consolidated_matches_jax(trainer_runs):
    out, _, _, trainer = trainer_runs
    want = dict(np.load(os.path.join(out, "consolidated.npz")))
    rows = tr.tree_leaves(trainer.state.params)
    assert any(not torch.equal(a[0], a[-1]) for a in rows)   # groups apart
    got = rank_runs.flat_tree(trainer.consolidated())
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(got[k].numpy(), w, rtol=TRAINER_RTOL,
                                   atol=TRAINER_RTOL * scale, err_msg=k)


def test_trainer_consolidated_over_ranks_is_rank_0s(trainer_runs):
    out, cfg, kw, trainer = trainer_runs
    ranks = rank_runs.spawn(
        "consolidated", P, os.path.join(out, "ranks"), data=P, arch=T_ARCH,
        init=os.path.join(out, "init"), trainer_kw=kw, steps=STEPS)
    assert [bool(r["is_none"]) for r in ranks] == [False, True, True, True]
    want = rank_runs.flat_tree(trainer.consolidated())
    got = {k[len("cons/"):]: v for k, v in ranks[0].items()
           if k.startswith("cons/")}
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert np.array_equal(got[k], w.numpy()), k
