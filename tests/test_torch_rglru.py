"""The port's RG-LRU scan (K4) and recurrentgemma model against the JAX
package, on the CPU.

K4: on CPU tensors the port's dispatcher takes the plain torch loop; it and
the port's oracle are held against the Pallas kernel (interpret mode, as
tests/test_kernels.py runs it) and the JAX oracle at 1e-6, and against the
JAX model's associative scan at 1e-4, on tests/test_kernels.py's shapes.
The kernel itself runs only on a CUDA card
(tests/test_torch_kernels_cuda.py holds it to the plain loop bit for bit).

Model: weights come from the JAX init and cross as numpy
(``params_from_jax``); tokens come from numpy.  ``forward``, ``prefill``
(last logits and every cache leaf) and four ``decode_step``s must match to
1e-4 in float32, on the smoke config, on a 5-layer variant (which has a
tail of recurrent layers), and with both packages' ``ATTN_WINDOW`` patched
below the prompt length so that the ring cache wraps.  The JAX reference
runs without a mesh.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rglru as jax_rglru
from repro.configs import get_config as jax_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.registry import build_model as jax_build
from repro.serve.kv_cache import init_paged_pool as jax_paged_pool
from repro_torch.configs import get_config
from repro_torch.core import tree as tr
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg
from repro_torch.models import rglru
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.serve import init_paged_pool

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import RGLRU_CASES  # noqa: E402  (tests/test_kernels.py's)

ARCH = "recurrentgemma-2b"
TOL = 1e-4


def _scan_inputs(case):
    b, s, w, with_h0 = case
    rng = np.random.default_rng(abs(hash(case)) % 2**31)
    a = rng.uniform(0.5, 0.999, (b, s, w)).astype(np.float32)
    x = (rng.standard_normal((b, s, w)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    return a, x, h0


def _jax_and_torch(a, x, h0):
    j = tuple(None if t is None else jnp.asarray(t) for t in (a, x, h0))
    t = tuple(None if v is None else torch.from_numpy(v) for v in (a, x, h0))
    return j, t


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_scan_plain_and_ref_match_pallas_and_jax_ref(case):
    (ja, jx, jh), (ta, tx, th) = _jax_and_torch(*_scan_inputs(case))
    pallas = np.asarray(jops.rglru_scan(ja, jx, jh))
    oracle = np.asarray(jref.rglru_scan_ref(ja, jx, jh))
    for got in (ops.rglru_scan(ta, tx, th), rg.rglru_scan_plain(ta, tx, th),
                ref.rglru_scan_ref(ta, tx, th)):
        assert got.dtype == tx.dtype and got.shape == tx.shape
        for want in (pallas, oracle):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("case", RGLRU_CASES)
def test_scan_matches_jax_model_associative_scan(case):
    (ja, jx, jh), (ta, tx, th) = _jax_and_torch(*_scan_inputs(case))
    want = np.asarray(jax_rglru.rglru_scan(ja, jx, jh))
    np.testing.assert_allclose(ops.rglru_scan(ta, tx, th).numpy(), want,
                               rtol=TOL, atol=TOL)


def test_scan_plain_bfloat16_casts_each_step_of_an_fp32_carry():
    a, x, h0 = _scan_inputs((2, 33, 20, True))
    ta = torch.from_numpy(a).bfloat16()
    tx = torch.from_numpy(x).bfloat16()
    th = torch.from_numpy(h0)
    want = jref.rglru_scan_ref(jnp.asarray(ta.float().numpy(), jnp.bfloat16),
                               jnp.asarray(tx.float().numpy(), jnp.bfloat16),
                               jnp.asarray(h0))
    got = ops.rglru_scan(ta, tx, th)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    assert torch.equal(got, ref.rglru_scan_ref(ta, tx, th))


F32, BF16 = torch.float32, torch.bfloat16
ALIGNED = (1 << 20, 2 << 20, 3 << 20)          # a, x, out base pointers


@pytest.mark.parametrize("args, want", [
    ((3000, 2560, F32, F32, ALIGNED), "tma"),        # the prefill
    ((3000, 2560, BF16, BF16, ALIGNED), "tma"),
    ((3000, 2560, BF16, F32, ALIGNED), "tma"),       # mixed
    ((1, 2560, F32, F32, ALIGNED), "walk"),          # decode: S = 1
    ((rg.TMA_STEPS - 1, 2560, F32, F32, ALIGNED), "walk"),
    ((rg.TMA_STEPS, 32, F32, F32, ALIGNED), "tma"),
    ((3000, 1001, F32, F32, ALIGNED), "walk"),       # rows of 4004 bytes
    ((3000, 2564, F32, F32, ALIGNED), "tma"),        # 10256-byte rows
    ((3000, 2564, BF16, F32, ALIGNED), "walk"),      # a's rows 5128 bytes
    ((3000, 2560, F32, F32, (1 << 20, (2 << 20) + 4, 3 << 20)), "walk"),
    ((3000, 2560, F32, F32, (1 << 20, 2 << 20, (3 << 20) + 8)), "walk"),
], ids=["prefill", "prefill-bf16", "prefill-mixed", "decode", "S-under-slot",
        "one-slot-one-box", "W1001", "W2564", "W2564-bf16-a", "x-misaligned",
        "out-misaligned"])
def test_scan_route_rule(args, want):
    """The wrapper's route: TMA for S >= one slot, 16-byte rows of a and x
    and 16-byte-aligned pointers; the walk route for everything else."""
    assert rg.route(*args) == want


def test_scan_route_of_a_view_follows_its_pointer():
    """A contiguous view one element into its buffer is not 16-byte
    aligned, so the rule sends it down the walk route."""
    buf = torch.zeros(2 * 3000 * 2560 + 1)
    view = buf[1:].view(2, 3000, 2560)
    whole = buf[:-1].view(2, 3000, 2560)
    for t, want in ((view, "walk"), (whole, "tma")):
        assert rg.route(3000, 2560, t.dtype, t.dtype,
                        (t.data_ptr(), t.data_ptr(), whole.data_ptr())) == want


def test_scan_cpu_dispatch_counts_nothing_and_refuses_gradients():
    (_, (ta, tx, th)) = _jax_and_torch(*_scan_inputs((2, 9, 8, True)))
    ops.reset_launch_counts()
    ops.rglru_scan(ta, tx, th)
    counts = ops.launch_counts()
    assert counts["rglru_scan"] == counts["rglru_scan_tma"] == \
        counts["rglru_scan_walk"] == 0
    for needs in (ta, tx, th):
        needs.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            ops.rglru_scan(ta, tx, th)
        with torch.no_grad():
            assert ops.rglru_scan(ta, tx, th).grad_fn is None
        needs.requires_grad_(False)
    with pytest.raises(ValueError):
        ops.rglru_scan(ta.to("meta"), tx.to("meta"))


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape
                                                ).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _leaves(tree):
    return tr.tree_leaves(tree)


@pytest.fixture(scope="module", params=[3, 5], ids=["smoke", "tail"])
def pair(request):
    cfg = get_config(ARCH, smoke=True).variant(dtype="float32",
                                               n_layers=request.param)
    jm = jax_build(jax_config(ARCH, smoke=True).variant(
        dtype="float32", n_layers=request.param))
    jparams = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jm, jparams, model, params


@pytest.mark.parametrize("window", [None, 8, 24], ids=["2048", "8", "24"])
def test_forward_prefill_decode_match_jax(pair, window, monkeypatch):
    """With a window of 8 or 24 the 37-token prompt wraps the ring cache."""
    cfg, jm, jparams, model, params = pair
    if window is not None:
        monkeypatch.setattr(jax_rglru, "ATTN_WINDOW", window)
        monkeypatch.setattr(rglru, "ATTN_WINDOW", window)
    s, max_len = 37, 48
    toks = _tokens(cfg, (2, 40), 0)
    # fresh lambdas: no JAX trace cached under another window is reused
    want, _ = jax.jit(lambda p, b: jm.forward(p, b))(
        jparams, {"tokens": jnp.asarray(toks)})
    got, _ = model.forward(params, {"tokens": _t(toks)})
    _close(got, want)

    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len))(
        jparams, {"tokens": jnp.asarray(toks[:, :s])})
    tl, tc = model.prefill(params, {"tokens": _t(toks[:, :s])}, max_len)
    _close(tl, jl)
    assert set(tc) == set(jc)
    ring = min(window or rglru.ATTN_WINDOW, max_len)
    assert tc["attn"]["k"].shape[2] == ring
    jleaves, tleaves = jax.tree.leaves(jc), _leaves(tc)
    assert len(jleaves) == len(tleaves) == 2 * len(tc)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape and t.dtype == getattr(
            torch, str(j.dtype))
        _close(t, j)

    jstep = jax.jit(lambda p, c, tok, pos: jm.decode_step(p, c, tok, pos))
    feed = _tokens(cfg, (4, 2, 1), 2)
    for t in range(4):
        jl, jc = jstep(jparams, jc, jnp.asarray(feed[t]), jnp.asarray(s + t))
        tl, tc = model.decode_step(params, tc, _t(feed[t]), s + t)
        _close(tl, jl)
    for j, t in zip(jax.tree.leaves(jc), _leaves(tc)):
        _close(t, j)


def test_param_tree_and_init_match_jax():
    """The port's tree, shapes and dtypes are the JAX init's, in bf16 with
    ``lam`` float32; ``params_from_jax`` keeps ``lam`` float32 exactly and
    refuses a dense tree."""
    for n_layers in (3, 5, 26):
        cfg = get_config(ARCH, smoke=n_layers != 26).variant(n_layers=n_layers)
        jcfg = jax_config(ARCH, smoke=n_layers != 26).variant(
            n_layers=n_layers)
        want = jax.eval_shape(lambda: jax_rglru.init_params(
            jcfg, jax.random.PRNGKey(0)))
        assert jax.tree.map(lambda a: tuple(a.shape), want) == \
            rglru.param_shapes(cfg)
        specs = rglru.param_specs(cfg)
        assert jax.tree.map(lambda a: str(a.dtype), want) == \
            tr.tree_map(lambda sp: str(sp.dtype).split(".")[1], specs)
    cfg = get_config(ARCH, smoke=True)
    jparams = jax_rglru.init_params(jax_config(ARCH, smoke=True),
                                    jax.random.PRNGKey(1))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    lam = params["blocks"]["rec1"]["lam"]
    assert lam.dtype == torch.float32
    np.testing.assert_array_equal(lam.numpy(),
                                  np.asarray(jparams["blocks"]["rec1"]["lam"]))
    assert params["blocks"]["rec1"]["w_x"].dtype == torch.bfloat16
    mine = rglru.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tr.tree_map(lambda a: (tuple(a.shape), a.dtype), mine) == \
        tr.tree_map(lambda sp: (sp.shape, sp.dtype), rglru.param_specs(cfg))
    np.testing.assert_allclose(mine["blocks"]["rec1"]["lam"].numpy(),
                               lam.numpy(), rtol=1e-6, atol=0)
    dense = jax_build(jax_config("tinyllama-1.1b", smoke=True)).init(
        jax.random.PRNGKey(0))
    with pytest.raises(ValueError):
        params_from_jax(cfg, jax.tree.map(np.asarray, dense), "cpu")


def test_paged_pool_refuses_recurrentgemma_like_jax():
    cfg = get_config(ARCH, smoke=True)
    with pytest.raises(NotImplementedError, match="global"):
        jax_paged_pool(jax_build(jax_config(ARCH, smoke=True)), 8, 4)
    with pytest.raises(NotImplementedError, match="global"):
        init_paged_pool(build_model(cfg, device="cpu"), 8, 4)


def test_loss_returns_a_finite_scalar_on_cpu():
    """The smoke config's training loss: a finite float32 scalar, the
    metrics' ``ce``, with a gradient for every leaf."""
    cfg = get_config(ARCH, smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = _t(_tokens(cfg, (2, 17), 3))
    leaves, treedef = tr.tree_flatten(params)
    leaves = [l.requires_grad_(True) for l in leaves]
    loss, metrics = model.loss(tr.tree_unflatten(treedef, leaves),
                               {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert loss.shape == () and loss.dtype == torch.float32
    assert bool(torch.isfinite(loss)) and metrics["ce"] is loss
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
