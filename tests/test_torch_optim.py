"""The port's optimisers and schedules against the JAX package's: five
updates from the same numpy params and gradients agree to 1e-6 (float32
sums in another order); moments are float32 for bf16 params too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt

TOL = 1e-6
SHAPES = {"a": (7, 5), "b": {"c": (11,), "d": (2, 3, 4)}}


def _tree(rng, node=SHAPES):
    if isinstance(node, dict):
        return {k: _tree(rng, v) for k, v in node.items()}
    return rng.standard_normal(node).astype(np.float32)


def _leaves(t):
    return jax.tree.leaves(t)


CASES = [
    ("sgd", dict(learning_rate=0.1, momentum=0.9)),
    ("sgd", dict(learning_rate=0.05, momentum=0.9, nesterov=True,
                 weight_decay=0.01)),
    ("adamw", dict(learning_rate=1e-2, weight_decay=0.1)),
    ("sgd_cosine", dict()),
]


def _make(mod, name, kw):
    if name == "sgd_cosine":
        return mod.sgd(mod.cosine_warmup(0.2, 2, 5), momentum=0.9)
    return getattr(mod, name)(**kw)


@pytest.mark.parametrize("name,kw", CASES)
def test_five_updates_match_jax(name, kw):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng) for _ in range(5)]
    jo, to = _make(jopt, name, kw), _make(topt, name, kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(torch.from_numpy, params)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jp, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = to.update(jax.tree.map(torch.from_numpy, g), ts, tp)
    for a, b in zip(_leaves(tp), _leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    for f in js._fields:
        if f == "count":
            assert int(ts.count) == int(js.count) == 5
            continue
        for a, b in zip(_leaves(getattr(ts, f)), _leaves(getattr(js, f))):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                       atol=TOL)


def test_bf16_params_keep_float32_moments():
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    for opt in (topt.sgd(0.1), topt.adamw(0.1)):
        state = opt.init(p)
        new_p, state = opt.update({"w": torch.ones_like(p["w"])}, state, p)
        assert new_p["w"].dtype == torch.bfloat16
        assert all(l.dtype == torch.float32 for f in state._fields
                   if f != "count" for l in _leaves(getattr(state, f)))


def test_schedules_match_jax():
    for step in range(12):
        np.testing.assert_allclose(
            float(topt.cosine_warmup(0.3, 3, 10)(step)),
            float(jopt.cosine_warmup(0.3, 3, 10)(jnp.asarray(step))),
            rtol=TOL)
        assert float(topt.constant(0.7)(step)) == \
            float(jopt.constant(0.7)(step))
