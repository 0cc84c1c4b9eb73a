"""The port's training path against the JAX package's at smoke size in
float32: the loss and its gradients against ``jax.value_and_grad`` of the
JAX ``model.loss``; six ``Trainer`` steps (all three phase offsets and one
tau-sync) from the same ``ReplicaState`` against the JAX ``Trainer`` on an
8-device host mesh with Auto axes (ROADMAP.md F1); the per-replica
non-finite guard; the CLI.  The JAX Trainer runs once, in a subprocess."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from subproc import SRC, run_sub

from repro.configs import get_config as jax_config
from repro.core.replica import ReplicaState as JState
from repro.models.registry import build_model as jax_build
from repro.optim.sgd import SGDState as JSGDState
from repro_torch.configs import get_config
from repro_torch.core import tree as tr
from repro_torch.launch.train import Trainer
from repro_torch.models.convert import params_from_jax, replica_state_from_jax
from repro_torch.models.registry import build_model

RTOL = 1e-5
ARCH, P, S, TAU, SEQ, GB, STEPS = "tinyllama-1.1b", 8, 4, 5, 16, 16, 6


def _cfgs(arch, **kw):
    return (get_config(arch, smoke=True).variant(dtype="float32", **kw),
            jax_config(arch, smoke=True).variant(dtype="float32", **kw))


def _close(got, want, rtol=RTOL, atol=RTOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


@pytest.mark.parametrize("arch,kw", [
    ("tinyllama-1.1b", {}),
    ("qwen3-0.6b", {}),
    ("starcoder2-7b", {}),
    # windows of 32 over 48 tokens in 16-token blocks: windowed block visits
    ("gemma3-12b", dict(attn_block_q=16, attn_block_k=16)),
])
def test_loss_and_grads_match_jax_value_and_grad(arch, kw):
    cfg, jcfg = _cfgs(arch, **kw)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 49)).astype(np.int32)
    mask = (rng.random((2, 48)) > 0.2).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:]), "mask": jnp.asarray(mask)}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jparams, jbatch)
    model = build_model(cfg, device="cpu")
    batch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    for remat in (True, False):
        leaves, treedef = tr.tree_flatten(params_from_jax(
            cfg, jax.tree.map(np.asarray, jparams), "cpu"))
        leaves = [l.requires_grad_(True) for l in leaves]
        loss, metrics = model.loss(tr.tree_unflatten(treedef, leaves), batch,
                                   remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        _close(loss.item(), float(jloss))
        assert metrics["ce"] is metrics["loss"]
        for g, jg_ in zip(grads, jax.tree.leaves(jgrads)):
            scale = float(np.abs(np.asarray(jg_)).max()) or 1.0
            _close(g.numpy(), jg_, atol=RTOL * scale)


# ---------------------------------------------------------------------------
# Six Trainer steps against the JAX Trainer
# ---------------------------------------------------------------------------

JAX_TRAINER = """
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.launch.train import Trainer
    cfg = get_config({arch!r}, smoke=True).variant(dtype="float32")
    mesh = jax.make_mesh(({P}, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    tr = Trainer(cfg, mesh, group_size={S}, tau={TAU}, seq_len={SEQ},
                 global_batch={GB}, seed=0)

    def flat(prefix, tree):
        return {{prefix + "/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(v) for path, v in
                jax.tree_util.tree_leaves_with_path(tree)}}

    s0 = jax.device_get(tr.state)
    out = {{**flat("p0/", s0.params), **flat("m0/", s0.opt_state.momentum)}}
    losses = []
    with compat.set_mesh(mesh):
        for t in range({STEPS}):
            losses.append(tr.step_once(t))
    s1 = jax.device_get(tr.state)
    out.update(flat("p1/", s1.params))
    out.update(flat("m1/", s1.opt_state.momentum))
    out["losses"] = np.asarray(losses)
    out["count"] = np.asarray(s1.opt_state.count)
    out["step_phase"] = np.asarray([int(s1.step), int(s1.phase)])
    np.savez({outp!r}, **out)
    print("JAX_TRAINER_DONE")
"""


def _nest(flat, prefix):
    out = {}
    for key, val in flat.items():
        if not key.startswith(prefix):
            continue
        node = out
        parts = key[len(prefix):].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    outp = str(tmp_path_factory.mktemp("train") / "jax.npz")
    out = run_sub(JAX_TRAINER.format(arch=ARCH, P=P, S=S, TAU=TAU, SEQ=SEQ,
                                     GB=GB, STEPS=STEPS, outp=outp))
    assert "JAX_TRAINER_DONE" in out
    return dict(np.load(outp))


def _jax_state(res, tag):
    """The JAX ReplicaState (numpy leaves) saved under ``tag``."""
    return JState(_nest(res, f"p{tag}/"),
                  JSGDState(_nest(res, f"m{tag}/"), np.zeros(P, np.int32)),
                  np.int32(0), np.int32(-1))


def test_six_trainer_steps_match_jax_trainer(jax_trainer):
    cfg, _ = _cfgs(ARCH)
    state = replica_state_from_jax(cfg, _jax_state(jax_trainer, 0), "cpu")
    trainer = Trainer(cfg, P, device="cpu", group_size=S, tau=TAU,
                      seq_len=SEQ, global_batch=GB, seed=0, init_state=state)
    keys = [("group", 0), ("group", 1), ("group", 2), ("group", 0), ("sync",),
            ("group", 1)]
    losses = []
    for t in range(STEPS):
        losses.append(trainer.step_once(t))
        assert list(trainer._steps)[-1] == keys[t] or keys[t] in \
            trainer._steps
    assert set(trainer._steps) == {("group", 0), ("group", 1), ("group", 2),
                                   ("sync",)}
    _close(losses, jax_trainer["losses"])
    assert (trainer.state.step, trainer.state.phase) == \
        tuple(jax_trainer["step_phase"])
    assert trainer.state.opt_state.count.tolist() == \
        jax_trainer["count"].tolist()
    assert trainer.skipped_nonfinite == 0
    want = replica_state_from_jax(cfg, _jax_state(jax_trainer, 1), "cpu")
    for tag, got_tree, want_tree in (
            ("params", trainer.state.params, want.params),
            ("momentum", trainer.state.opt_state.momentum,
             want.opt_state.momentum)):
        for g, w in zip(tr.tree_leaves(got_tree), tr.tree_leaves(want_tree)):
            scale = float(w.abs().max()) or 1.0
            _close(g.numpy(), w.numpy(), atol=RTOL * scale, msg=tag)


def test_replica_state_from_jax_layouts(jax_trainer):
    cfg, _ = _cfgs(ARCH)
    state = replica_state_from_jax(cfg, _jax_state(jax_trainer, 0), "cpu")
    assert tr.tree_leaves(state.params)[0].shape[0] == P
    assert state.opt_state.count.dtype == torch.int32
    assert all(m.dtype == torch.float32
               for m in tr.tree_leaves(state.opt_state.momentum))
    for a, b in zip(tr.tree_leaves(state.params),
                    jax.tree.leaves(_nest(jax_trainer, "p0/"))):
        assert np.array_equal(a.numpy(), b)
    with pytest.raises(TypeError):
        replica_state_from_jax(cfg, JState(_nest(jax_trainer, "p0/"),
                                           (1, 2), 0, -1), "cpu")


def test_nan_batch_skips_only_that_replicas_update():
    cfg, _ = _cfgs(ARCH)
    trainer = Trainer(cfg, P, device="cpu", group_size=S, tau=TAU,
                      seq_len=SEQ, global_batch=GB, seed=0)
    before = tr.tree_map(lambda a: a.clone(), trainer.state.params)
    mom_before = tr.tree_map(lambda a: a.clone(),
                             trainer.state.opt_state.momentum)
    seen = []
    comm = trainer.averager.comm
    trainer.averager.comm = lambda tree, phase: (seen.append(tree),
                                                 comm(tree, phase))[1]
    bad, b = 3, GB // P
    batch = trainer._put_batch(0)
    batch["mask"] = torch.ones_like(batch["labels"], dtype=torch.float32)
    batch["mask"][bad * b:(bad + 1) * b] = float("nan")
    trainer.state, metrics = trainer._step_fn(0)(trainer.state, batch)
    assert float(metrics["skipped_nonfinite"]) == 1.0 / P
    assert trainer.state.opt_state.count.tolist() == \
        [0 if r == bad else 1 for r in range(P)]
    for pre, old, m, m_old in zip(tr.tree_leaves(seen[0]),
                                  tr.tree_leaves(before),
                                  tr.tree_leaves(
                                      trainer.state.opt_state.momentum),
                                  tr.tree_leaves(mom_before)):
        assert torch.equal(pre[bad], old[bad])      # update skipped, exact
        assert torch.equal(m[bad], m_old[bad])
        others = [r for r in range(P) if r != bad]
        assert torch.isfinite(pre).all()
        if old.dim() > 1 and old.shape[-1] > 1:
            assert not torch.equal(m[others], m_old[others])


def _cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_TORCH_DEVICE="cpu",
               **(env_extra or {}))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_cli_trains_at_smoke_size_and_names_missing_slices():
    out = _cli("--arch", ARCH, "--smoke", "--data-axis", "8",
               "--group-size", "4", "--tau", "3", "--steps", "4",
               "--seq-len", "16", "--global-batch", "16", "--microbatch", "2")
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout and "step     3" in out.stdout
    # one intra-op thread: under the suite's parallel workers more only
    # contend, and this model's many small ops slow by tens of times
    out = _cli("--arch", "recurrentgemma-2b", "--smoke", "--data-axis", "4",
               "--group-size", "2", "--tau", "3", "--steps", "4",
               "--seq-len", "16", "--global-batch", "8",
               env_extra={"OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout and "step     3" in out.stdout
    # a baseline averager trains (it raised before the baselines slice)
    out = _cli("--arch", ARCH, "--smoke", "--data-axis", "8", "--averager",
               "dpsgd", "--steps", "2", "--seq-len", "16", "--global-batch",
               "16")
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout
    # --pod-axis and --pod-dcn train since slice 4a (tests/
    # test_torch_train_ranks.py), --sharding fsdp since slice 7a (tests/
    # test_torch_fsdp.py), its streamed layout since slice 7b (tests/
    # test_torch_streaming.py), --model-axis under torchrun since slice 4b
    # (tests/test_torch_model_axis.py; every family since slice 4c)
    for streamed in ((), ("--streamed",)):
        out = _cli("--arch", ARCH, "--smoke", "--data-axis", "2",
                   "--pod-axis", "4", "--pod-dcn", "--sharding", "fsdp",
                   *streamed, "--group-size", "2", "--steps", "2",
                   "--seq-len", "16", "--global-batch", "16")
        assert out.returncode == 0, out.stderr
        assert "final loss" in out.stdout
    for flags, slice_name in ((("--streamed",), "requires --sharding fsdp"),
                              (("--model-axis", "2"), "torchrun"),
                              (("--arch", "xlstm-350m", "--model-axis", "2"),
                               "torchrun"),
                              (("--multi-pod",), "--pod-axis")):
        out = _cli("--smoke", "--data-axis", "8", "--steps", "1", *flags)
        assert out.returncode != 0 and slice_name in out.stderr, flags
