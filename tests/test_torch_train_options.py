"""The port's ``Trainer`` options against the JAX ``Trainer`` on the
tinyllama smoke config in float32: gradient accumulation over two
microbatches of the length-imbalanced (masked) batches, and AdamW.  Six
steps each (all three phase offsets and the tau-sync at t = 4) from the JAX
run's initial state; both JAX runs share one subprocess."""

import pytest

from jax_trainer_runs import check_trainer_matches, one_torch_thread, \
    run_jax_trainers  # noqa: F401  (an autouse fixture)
from repro_torch.configs import get_config

ARCH, P, S, TAU, SEQ, GB, STEPS = "tinyllama-1.1b", 8, 4, 5, 16, 16, 6
BASE = dict(group_size=S, tau=TAU, seq_len=SEQ, global_batch=GB, seed=0)
# AdamW at its usual rate: at the Trainer's default of 0.1 every element
# moves by about 0.1 a step, the loss rises, and the two packages' float32
# roundings grow tenfold a step (loss 4.8e-7 apart at step 0, 3.6e-3 at
# step 5), so no tolerance short of the params' own size would hold.
ADAMW_LR = 1e-3
RUNS = {
    "microbatch": dict(BASE, microbatch=2, imbalanced=True),
    "adamw": dict(BASE, optimizer="adamw", learning_rate=ADAMW_LR),
}
# SGD: the step is linear in the gradient, so the port stays within the
# float32 roundings of the gradient sums (measured 3.3e-6 of each leaf's
# largest magnitude), as tests/test_torch_train.py's 1e-5.
SGD_RTOL = 1e-5
# AdamW divides the first moment by the root of the second, so its step has
# the size of the learning rate whatever the gradient's size: a gradient
# element near zero, whose float32 rounding is a large part of it, still
# moves its param by up to lr, and in a leaf that starts at zero (the norm
# scales, whose largest element is a few lr after six steps) that is a few
# percent of the leaf's largest magnitude times the element's relative
# error (measured 6.6e-5 for params, 1.4e-5 for the moments).  5e-4 holds
# that with room; a step of the wrong sign, or a bias correction one step
# off, moves an element by about lr, 2e-3 or more of every leaf's largest
# magnitude, and fails it.
ADAMW_RTOL = 5e-4


@pytest.fixture(scope="module")
def jax_trainers(tmp_path_factory):
    outp = str(tmp_path_factory.mktemp("train_options") / "jax.npz")
    return run_jax_trainers(
        {name: (ARCH, {}, P, kw, STEPS) for name, kw in RUNS.items()}, outp,
        devices=P)


def _cfg():
    return get_config(ARCH, smoke=True).variant(dtype="float32")


def test_microbatch_imbalanced_trainer_matches_jax_trainer(jax_trainers):
    trainer = check_trainer_matches(jax_trainers, "microbatch", _cfg(), P,
                                    RUNS["microbatch"], STEPS, SGD_RTOL)
    assert trainer.microbatch == 2
    assert "mask" in trainer._put_batch(0)


def test_adamw_trainer_matches_jax_trainer(jax_trainers):
    trainer = check_trainer_matches(jax_trainers, "adamw", _cfg(), P,
                                    RUNS["adamw"], STEPS, ADAMW_RTOL,
                                    optimizer="adamw")
    assert set(trainer.state.opt_state._fields) == {"mu", "nu", "count"}
