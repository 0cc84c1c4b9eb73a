"""The port's ``Trainer`` under the baseline averagers that are not gossip
(Allreduce-SGD, Eager-SGD, local SGD) against the JAX ``Trainer``, on
transformer-wmt's smoke config in float32 (the paper's own model, the
encoder-decoder family): P = 4, 6 steps each from the JAX run's initial
state, local SGD's sync at t = 4 (``sync_period`` = tau = 5).
Allreduce-SGD and Eager-SGD take the gradient-averaging branch of the
train step.  Losses within 1e-5, params and momentum within 1e-5 of each
leaf's largest magnitude; the JAX runs share one subprocess.  The gossip
baselines are ``tests/test_torch_train_gossip.py``'s (a second file, so
that the two JAX subprocesses run on two workers).  Also the CLI on the
CPU with a baseline."""

import os
import subprocess
import sys

import pytest

from jax_trainer_runs import check_trainer_matches, one_torch_thread, \
    run_jax_trainers  # noqa: F401  (an autouse fixture)
from subproc import SRC
from repro_torch.configs import get_config

ARCH, P, TAU, SEQ, GB, STEPS = "transformer-wmt", 4, 5, 16, 8, 6
NAMES = ("allreduce", "local_sgd", "eager_sgd")
RUNS = {name: dict(averager=name, tau=TAU, seq_len=SEQ, global_batch=GB,
                   seed=0) for name in NAMES}
RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_trainers(tmp_path_factory):
    outp = str(tmp_path_factory.mktemp("train_baselines") / "jax.npz")
    return run_jax_trainers(
        {name: (ARCH, {}, P, kw, STEPS) for name, kw in RUNS.items()}, outp,
        devices=P)


@pytest.mark.parametrize("name", NAMES)
def test_baseline_trainer_matches_jax_trainer(name, jax_trainers):
    cfg = get_config(ARCH, smoke=True).variant(dtype="float32")
    trainer = check_trainer_matches(jax_trainers, name, cfg, P, RUNS[name],
                                    STEPS, RTOL)
    avg = trainer.averager
    assert avg.name == name
    assert avg.grad_comm == (name in ("allreduce", "eager_sgd"))
    if name == "local_sgd":
        assert avg.sync_period == TAU and ("sync",) in trainer._steps
    assert "src" in trainer._put_batch(0)


def test_cli_trains_transformer_wmt_with_a_baseline_on_cpu():
    env = dict(os.environ, REPRO_TORCH_DEVICE="cpu", PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--averager", "dpsgd", "--data-axis", "4", "--steps",
         "3", "--seq-len", "16", "--global-batch", "8"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "final loss" in out.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--averager", "nope", "--data-axis", "4"],
        capture_output=True, text=True, env=env, timeout=300)
    assert bad.returncode != 0 and "invalid choice" in bad.stderr


def test_nan_batch_makes_every_replica_skip_under_allreduce():
    """The gradient average spreads one replica's NaN to every row, and
    the guard reads the averaged gradients (as the JAX ``grad_comm``
    branch does): every replica skips its update, bit-exact."""
    import torch
    from repro_torch.core import tree as tr
    from repro_torch.launch.train import Trainer

    cfg = get_config(ARCH, smoke=True).variant(dtype="float32")
    trainer = Trainer(cfg, P, device="cpu", **RUNS["allreduce"])
    before = tr.tree_map(lambda a: a.clone(), trainer.state.params)
    b = GB // P
    batch = trainer._put_batch(0)
    batch["mask"] = torch.ones_like(batch["labels"], dtype=torch.float32)
    batch["mask"][b:2 * b] = float("nan")
    trainer.state, metrics = trainer._step_fn(0)(trainer.state, batch)
    assert float(metrics["skipped_nonfinite"]) == 1.0
    assert trainer.state.opt_state.count.tolist() == [0] * P
    for new, old in zip(tr.tree_leaves(trainer.state.params),
                        tr.tree_leaves(before)):
        assert torch.equal(new, old)
    # a clean step then updates every row alike
    trainer.step_once(1)
    assert trainer.state.opt_state.count.tolist() == [1] * P
    for leaf in tr.tree_leaves(trainer.state.params):
        assert all(torch.equal(leaf[r], leaf[0]) for r in range(1, P))
