"""The port's copy of the synthetic data pipeline gives the JAX package's
batches byte for byte for the same (cfg, shape, seed, step, worker)."""

import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.configs.base import InputShape as JShape
from repro.data import SyntheticTask as JTask
from repro.data import make_batch_fn as jax_batch_fn
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import SyntheticTask, make_batch_fn


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen3-0.6b"])
@pytest.mark.parametrize("imbalanced", [False, True])
def test_batches_byte_identical(arch, imbalanced):
    for smoke, seq, gb, seed in ((True, 16, 8, 0), (False, 64, 4, 3)):
        fn = make_batch_fn(get_config(arch, smoke=smoke),
                           InputShape("custom", seq, gb, "train"), seed=seed,
                           imbalanced=imbalanced)
        jfn = jax_batch_fn(jax_config(arch, smoke=smoke),
                           JShape("custom", seq, gb, "train"), seed=seed,
                           imbalanced=imbalanced)
        for step, worker in ((0, 0), (1, 0), (7, 3)):
            _same(fn(step, worker, gb), jfn(step, worker, gb))


def test_task_batch_and_work_match():
    task, jtask = SyntheticTask(97, 12, seed=5), JTask(97, 12, seed=5)
    assert task.perm.tobytes() == jtask.perm.tobytes()
    for step in range(3):
        b, jb = task.batch(step, 1, 4), jtask.batch(step, 1, 4)
        _same(b, jb)
        assert task.work_per_batch(b) == jtask.work_per_batch(jb)
        ib = task.imbalanced_batch(step, 2, 4, median_len=5)
        _same(ib, jtask.imbalanced_batch(step, 2, 4, median_len=5))
        assert task.work_per_batch(ib) == jtask.work_per_batch(ib)
        assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
