"""The JAX package's ``Trainer`` as the oracle of the port's: runs in one
subprocess on a forced-host-device mesh with Auto axes (ROADMAP.md F1),
whose states and losses cross as numpy, and the comparison of the port's
``Trainer`` with them, and the fixture that runs torch on one thread.
Shared by the port's Trainer differential tests."""

import numpy as np
import pytest
import torch

from subproc import run_sub

from repro.core.replica import ReplicaState as JState
from repro.optim.adamw import AdamWState as JAdamWState
from repro.optim.sgd import SGDState as JSGDState
from repro_torch.core import tree as tr
from repro_torch.launch.train import Trainer
from repro_torch.models.convert import replica_state_from_jax


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Thousands of small ops: under the suite's parallel workers more
    intra-op threads only contend (a step slows by tens of times)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# each run: name -> (arch, config overrides, replicas P, Trainer kwargs,
# steps); the config is the smoke config in float32
SCRIPT = """
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.launch.train import Trainer

    def flat(prefix, tree):
        return {{prefix + "/".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(v) for path, v in
                jax.tree_util.tree_leaves_with_path(tree)}}

    def save(name, tag, state):
        out.update(flat(f"{{name}}/params{{tag}}/", state.params))
        for f in state.opt_state._fields:
            if f != "count":
                out.update(flat(f"{{name}}/{{f}}{{tag}}/",
                                getattr(state.opt_state, f)))

    out = {{}}
    for name, (arch, cfg_kw, n_rep, kw, steps) in {runs!r}.items():
        cfg = get_config(arch, smoke=True).variant(dtype="float32", **cfg_kw)
        mesh = jax.make_mesh((n_rep, 1), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)
        tr = Trainer(cfg, mesh, **kw)
        save(name, 0, jax.device_get(tr.state))
        with compat.set_mesh(mesh):
            losses = [tr.step_once(t) for t in range(steps)]
        s1 = jax.device_get(tr.state)
        save(name, 1, s1)
        out[f"{{name}}/losses"] = np.asarray(losses)
        out[f"{{name}}/count"] = np.asarray(s1.opt_state.count)
        out[f"{{name}}/step_phase"] = np.asarray([int(s1.step),
                                                 int(s1.phase)])
    np.savez({outp!r}, **out)
    print("JAX_TRAINERS_DONE")
"""


def run_jax_trainers(runs: dict, outp: str, devices: int) -> dict:
    """Run every JAX Trainer of ``runs`` in one subprocess; returns the
    saved arrays by key (``name/params0/...``, ``name/losses``, ...)."""
    out = run_sub(SCRIPT.format(runs=runs, outp=outp), devices=devices,
                  timeout=900)
    assert "JAX_TRAINERS_DONE" in out
    return dict(np.load(outp))


def nest(flat: dict, prefix: str) -> dict:
    """The tree saved under ``prefix`` (keys ``prefix + a/b/c``)."""
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


def jax_state(res: dict, name: str, tag: int, n_rep: int,
              optimizer: str = "sgd") -> JState:
    """The JAX ReplicaState (numpy leaves) of run ``name`` saved under
    ``tag`` (0 before the steps, 1 after); the count is not compared
    through it."""
    count = np.zeros(n_rep, np.int32)
    if optimizer == "sgd":
        opt = JSGDState(nest(res, f"{name}/momentum{tag}/"), count)
    else:
        opt = JAdamWState(nest(res, f"{name}/mu{tag}/"),
                          nest(res, f"{name}/nu{tag}/"), count)
    return JState(nest(res, f"{name}/params{tag}/"), opt, np.int32(0),
                  np.int32(-1))


def check_trainer_matches(res: dict, name: str, cfg, n_rep: int,
                          trainer_kw: dict, steps: int, rtol: float,
                          optimizer: str = "sgd") -> Trainer:
    """``steps`` of the port's ``Trainer`` from the JAX run's initial state
    against the JAX run: losses to ``rtol``, every param and optimiser
    moment leaf to ``rtol`` of that leaf's largest magnitude, and the
    counts, step and phase exactly.  Returns the port's trainer."""
    state = replica_state_from_jax(
        cfg, jax_state(res, name, 0, n_rep, optimizer), "cpu")
    trainer = Trainer(cfg, n_rep, device="cpu", init_state=state,
                      **trainer_kw)
    losses = [trainer.step_once(t) for t in range(steps)]
    np.testing.assert_allclose(losses, res[f"{name}/losses"], rtol=rtol,
                               atol=rtol)
    assert (trainer.state.step, trainer.state.phase) == \
        tuple(res[f"{name}/step_phase"])
    assert trainer.state.opt_state.count.tolist() == \
        res[f"{name}/count"].tolist()
    assert trainer.skipped_nonfinite == 0
    want = replica_state_from_jax(
        cfg, jax_state(res, name, 1, n_rep, optimizer), "cpu")
    trees = [("params", trainer.state.params, want.params)] + [
        (f, getattr(trainer.state.opt_state, f), getattr(want.opt_state, f))
        for f in trainer.state.opt_state._fields if f != "count"]
    for tag, got_tree, want_tree in trees:
        got_leaves, want_leaves = (tr.tree_leaves(got_tree),
                                   tr.tree_leaves(want_tree))
        assert len(got_leaves) == len(want_leaves)
        for g, w in zip(got_leaves, want_leaves):
            scale = float(w.abs().max()) or 1.0
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=rtol,
                                       atol=rtol * scale, err_msg=tag)
    return trainer
