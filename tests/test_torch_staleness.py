"""The port's straggler simulator (``core/staleness.py``) against the JAX
package's: 12 steps of ``wagma_sim_step`` (P = 8, S = 4, tau = 10, so the
sync at t = 9 runs) on the same stacked float32 and bfloat16 models, with
``local_update`` a fixed affine map written in both frameworks and the
straggler masks drawn by both ``StragglerModel``s from one seed.  The masks
must be equal, models and buffers agree to 1e-6, ``age`` and ``step``
exactly.  ``max_staleness_bound`` and ``SkipLedger`` must behave alike.

The convergence test is paper Fig. 5's claim at the JAX package's
laptop scale (``tests/test_system.py``'s
``test_wagma_converges_like_allreduce_under_stragglers``) on the port:
WAGMA under two stragglers an iteration ends within 1.06x of the
Allreduce-SGD baseline's loss.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import staleness as jst
from repro_torch.configs.base import ModelConfig
from repro_torch.core import staleness as st
from repro_torch.train import stragglers

P, S, TAU, STEPS = 8, 4, 10, 12
LEAVES = {"w": ((5, 3), np.float32), "b": ((7,), np.float32),
          "h": ((4,), jnp.bfloat16)}


def _models():
    rng = np.random.default_rng(0)
    return {k: rng.standard_normal((P,) + shape).astype(np.float32)
            for k, (shape, _) in LEAVES.items()}


def _scale():
    # each worker's affine map differs, so the rows diverge
    return np.linspace(0.8, 1.1, P).astype(np.float32)


def _jax_update(models):
    s = jnp.asarray(_scale())
    return {k: (v.astype(jnp.float32) * s.reshape((P,) + (1,) * (v.ndim - 1))
                + 0.01).astype(v.dtype) for k, v in models.items()}


def _torch_update(models):
    s = torch.from_numpy(_scale())
    return {k: (v.float() * s.reshape((P,) + (1,) * (v.dim() - 1))
                + 0.01).to(v.dtype) for k, v in models.items()}


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-6,
                               atol=1e-6)


def test_wagma_sim_step_matches_jax():
    arrs = _models()
    jstate = jst.init_state({k: jnp.asarray(a, LEAVES[k][1])
                             for k, a in arrs.items()})
    tstate = st.init_state({k: torch.from_numpy(a).to(
        torch.bfloat16 if LEAVES[k][1] == jnp.bfloat16 else torch.float32)
        for k, a in arrs.items()})
    jstrag = jst.StragglerModel(P, n_stragglers=2, p_stall=0.25, seed=3)
    tstrag = st.StragglerModel(P, n_stragglers=2, p_stall=0.25, seed=3)
    stalled = 0
    for t in range(STEPS):
        jr, jc = jstrag.sample()
        tr_, tc = tstrag.sample()
        np.testing.assert_array_equal(tr_.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        stalled += int((~tc).sum())
        jstate = jst.wagma_sim_step(jstate, _jax_update, P=P, S=S, tau=TAU,
                                    ready=jr, completes=jc, t=t)
        tstate = st.wagma_sim_step(tstate, _torch_update, P=P, S=S, tau=TAU,
                                   ready=tr_, completes=tc, t=t)
        for k in LEAVES:
            assert tstate.models[k].dtype == tstate.buffers[k].dtype
            _close(tstate.models[k], jstate.models[k])
            _close(tstate.buffers[k], jstate.buffers[k])
        assert tstate.age.tolist() == np.asarray(jstate.age).tolist()
        assert int(tstate.step) == int(jstate.step) == t + 1
        if t == TAU - 1:          # the sync resets every age
            assert tstate.age.tolist() == [0] * P
    assert stalled > 0            # some worker did not complete a step
    assert max(tstate.age.tolist()) <= st.max_staleness_bound(TAU)


def test_staleness_bookkeeping_matches_jax():
    for tau in (1, 5, 10):
        assert st.max_staleness_bound(tau) == jst.max_staleness_bound(tau)
    led, jled = st.SkipLedger(tau=3), jst.SkipLedger(tau=3)
    for worker, step in ((1, 0), (1, 1), (2, 1), (1, 2)):
        assert led.charge(worker, step) == jled.charge(worker, step)
    assert led.snapshot() == jled.snapshot()
    led.reset(1)
    jled.reset(1)
    led.drop(2)
    jled.drop(2)
    assert led.max_age() == jled.max_age() == 0
    assert led.snapshot() == jled.snapshot()
    for step in range(3):
        led.charge(4, step)
    with pytest.raises(st.StalenessBoundExceeded):
        led.charge(4, 3)
    assert led.peak_age == 4


def test_wagma_converges_like_allreduce_under_stragglers():
    """Paper Fig. 5's claim at laptop scale: same-budget final quality of
    WAGMA within a few percent of the synchronous baseline (the JAX
    package's test on the port: P = 8, S = 4, tau = 5, 60 steps)."""
    cfg = ModelConfig(name="sys-lm", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab=128,
                      dtype="float32")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        runs = {mode: stragglers.run(
            cfg, mode, replicas=8, group_size=4, tau=5, steps=60, seq_len=32,
            rows=2, learning_rate=0.4, device="cpu")
            for mode in stragglers.MODES}
    finally:
        torch.set_num_threads(threads)
    wagma, allr = runs["wagma"]["losses"], runs["allreduce"]["losses"]
    f_w, f_a = float(np.mean(wagma[-8:])), float(np.mean(allr[-8:]))
    assert wagma[-1] < wagma[0] * 0.8
    assert f_w <= f_a * 1.06, (f_w, f_a)
    assert runs["wagma"]["stalled"] > 0
