"""The port's ``Trainer`` under the gossip baselines (D-PSGD, SGP, AD-PSGD)
against the JAX ``Trainer``, on transformer-wmt's smoke config in float32:
P = 4, 6 steps each from the JAX run's initial state, both phases of SGP
and AD-PSGD (one bit of the replica index each).  Settings and tolerances are those of
``tests/test_torch_train_baselines.py`` (the other baselines); the JAX runs
share one subprocess."""

import pytest

from jax_trainer_runs import check_trainer_matches, one_torch_thread, \
    run_jax_trainers  # noqa: F401  (an autouse fixture)
from repro_torch.configs import get_config

ARCH, P, TAU, SEQ, GB, STEPS = "transformer-wmt", 4, 5, 16, 8, 6
NAMES = ("dpsgd", "sgp", "adpsgd")
RUNS = {name: dict(averager=name, tau=TAU, seq_len=SEQ, global_batch=GB,
                   seed=0) for name in NAMES}
RTOL = 1e-5


@pytest.fixture(scope="module")
def jax_trainers(tmp_path_factory):
    outp = str(tmp_path_factory.mktemp("train_gossip") / "jax.npz")
    return run_jax_trainers(
        {name: (ARCH, {}, P, kw, STEPS) for name, kw in RUNS.items()}, outp,
        devices=P)


@pytest.mark.parametrize("name", NAMES)
def test_gossip_trainer_matches_jax_trainer(name, jax_trainers):
    cfg = get_config(ARCH, smoke=True).variant(dtype="float32")
    trainer = check_trainer_matches(jax_trainers, name, cfg, P, RUNS[name],
                                    STEPS, RTOL)
    avg = trainer.averager
    assert avg.name == name and not avg.grad_comm
    phases = 1 if name == "dpsgd" else 2      # log2(P) rotating bits
    assert avg.n_phases == phases
    assert set(trainer._steps) == {("group", ph) for ph in range(phases)}
