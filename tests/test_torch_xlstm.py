"""xlstm-350m (``models/xlstm.py``) against the JAX package, on the CPU in
float32 from the same numpy inputs.

- ``kernels/ref.py``'s sequential mLSTM ``mlstm_chunk_ref`` (the port's
  ``mlstm_step`` a token) against the JAX one, also under extreme gate
  pre-activations, to ``REF_RTOL`` of the largest output.
- ``forward`` against the JAX forward to ``TOL`` of the largest logit.
- ``prefill`` and four ``decode_step``s against the JAX forward's logits at
  each position to ``DECODE_TOL`` (the JAX package's
  ``test_decode_matches_forward``), and the prefill's and the last step's
  states against the JAX caches, leaf by leaf.
- The loss and its gradient for every leaf against ``jax.value_and_grad``
  of the JAX ``model.loss``, remat on and off.
- The param tree (shapes and dtypes, ``bif``/``bg`` float32) and the cache
  shapes equal to the JAX init's, at smoke and full size.

Weights come from the JAX init and cross as numpy (``params_from_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ref as jax_ref
import repro.models.xlstm as jax_xlstm
from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.core import tree as tr
from repro_torch.kernels import ref
from repro_torch.models import registry, xlstm
from repro_torch.models.convert import params_from_jax

ARCH = "xlstm-350m"
TOL = 1e-4             # forward, of the largest logit
DECODE_TOL = 2e-3      # prefill + decode vs forward, rtol and atol
# one float32 recurrence in both packages, the same operations in the same
# order but for XLA's and torch's reductions (n.q and C q)
REF_RTOL = 1e-5
RTOL = 1e-5            # the loss; each gradient leaf, of its largest entry
GRAD_RTOL = 1e-4


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def _t(a, dtype=torch.int64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.fixture(scope="module")
def pair():
    cfg = get_config(ARCH, smoke=True).variant(dtype="float32")
    jm = jax_build(jax_config(ARCH, smoke=True).variant(dtype="float32"))
    jparams = jm.init(jax.random.PRNGKey(0))
    model = registry.build_model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jm, jparams, model, params


@pytest.mark.parametrize("b,s,h,dh,gate", [(1, 32, 2, 16, 30.0),
                                           (2, 17, 4, 8, 3.0),
                                           (3, 5, 1, 32, 0.5)])
def test_mlstm_chunk_ref_matches_jax(b, s, h, dh, gate):
    """Gates drawn in [-gate, gate]: at 30 the stabiliser carries every
    step (tests/test_kernels.py's stability case)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    i_pre, f_pre = (rng.uniform(-gate, gate, (b, s, h)).astype(np.float32)
                    for _ in range(2))
    want = jax_ref.mlstm_chunk_ref(*map(jnp.asarray, (q, k, v, i_pre,
                                                      f_pre)))
    got = ref.mlstm_chunk_ref(*(torch.from_numpy(a) for a in (q, k, v, i_pre,
                                                              f_pre)))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert torch.isfinite(got).all()
    _close(got, want, REF_RTOL)


def test_forward_matches_jax(pair):
    cfg, jm, jparams, model, params = pair
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))
    want, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    got, aux = model.forward(params, {"tokens": _t(toks)})
    assert aux == {} and tuple(got.shape) == want.shape
    _close(got, want, TOL)


def test_prefill_decode_match_jax_forward_and_caches(pair):
    """Prefill 8 tokens, then decode 4: each step's logits against the JAX
    forward at its position, the states against the JAX prefill's and
    decode steps' caches."""
    cfg, jm, jparams, model, params = pair
    T, T0 = 12, 8
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, T))
    full, _ = jm.forward(jparams, {"tokens": jnp.asarray(toks, jnp.int32)},
                         remat=False)
    full = np.asarray(full)

    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :T0],
                                                        jnp.int32)}, T)
    tl, tc = model.prefill(params, {"tokens": _t(toks[:, :T0])}, T)
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, T0 - 1],
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    assert set(tc) == set(jc) == {"mlstm", "slstm"}

    def states_match(tc, jc):
        jleaves, tleaves = jax.tree.leaves(jc), tr.tree_leaves(tc)
        assert len(jleaves) == len(tleaves) == 7
        for j, t in zip(jleaves, tleaves):
            assert tuple(t.shape) == j.shape and t.dtype == torch.float32
            # the stabilisers start at -1e30 and stay finite
            _close(t, j, TOL)

    states_match(tc, jc)
    for pos in range(T0, T):
        tok = toks[:, pos:pos + 1]
        jl, jc = jm.decode_step(jparams, jc, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos))
        tl, tc = model.decode_step(params, tc, _t(tok), pos)
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, pos],
                                   rtol=DECODE_TOL, atol=DECODE_TOL,
                                   err_msg=f"pos={pos}")
        _close(tl, jl, TOL)
    states_match(tc, jc)


@pytest.mark.parametrize("remat", [True, False])
def test_loss_and_grads_match_jax_value_and_grad(pair, remat):
    cfg, jm, jparams, model, _ = pair
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    mask = (rng.random((2, 12)) > 0.2).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:]), "mask": jnp.asarray(mask)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=remat), has_aux=True)(jparams,
                                                               jbatch)
    batch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    leaves, treedef = tr.tree_flatten(params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), "cpu"))
    leaves = [l.requires_grad_(True) for l in leaves]
    loss, metrics = model.loss(tr.tree_unflatten(treedef, leaves), batch,
                               remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL,
                               atol=RTOL)
    assert metrics["ce"] is metrics["loss"]
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        _close(g, jg, GRAD_RTOL)


@pytest.mark.parametrize("smoke", [True, False])
def test_param_tree_and_cache_shapes_match_jax(smoke):
    """Shapes and dtypes of the param tree (bf16, ``bif``/``bg`` float32)
    and of the caches equal the JAX init's; the port's own init draws that
    tree, with the JAX init's deterministic biases."""
    cfg, jcfg = get_config(ARCH, smoke=smoke), jax_config(ARCH, smoke=smoke)
    want = jax.eval_shape(lambda: jax_xlstm.init_params(
        jcfg, jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda a: tuple(a.shape), want) == \
        xlstm.param_shapes(cfg)
    assert jax.tree.map(lambda a: str(a.dtype), want) == tr.tree_map(
        lambda sp: str(sp.dtype).split(".")[1], xlstm.param_specs(cfg))
    jcaches = jax.eval_shape(lambda: jax_xlstm.init_caches(jcfg, 3, 16))
    caches = registry.build_model(cfg, device="meta").init_caches(3, 16)
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                        jcaches) == tr.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype).split(".")[1]), caches)
    if smoke:
        mine = xlstm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        assert tr.tree_map(lambda a: (tuple(a.shape), a.dtype), mine) == \
            tr.tree_map(lambda sp: (sp.shape, sp.dtype),
                        xlstm.param_specs(cfg))
        jparams = jax_xlstm.init_params(jcfg, jax.random.PRNGKey(1))
        for blk, name in (("mlstm", "bif"), ("slstm", "bg")):
            np.testing.assert_array_equal(
                mine["blocks"][blk][name].numpy(),
                np.asarray(jparams["blocks"][blk][name]))
        init = jax_xlstm.init_caches(jcfg, 3, 16)
        for j, t in zip(jax.tree.leaves(init), tr.tree_leaves(
                xlstm.init_caches(cfg, 3, 16, "cpu"))):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_build_model_serves_and_scores_in_bfloat16():
    """The bf16 smoke model through the registry: finite logits from the
    forward, the prefill and a decode step, and a finite scalar loss."""
    cfg = get_config(ARCH, smoke=True)
    model = registry.build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = _t(np.random.default_rng(0).integers(0, cfg.vocab, (2, 9)))
    logits, _ = model.forward(params, {"tokens": toks[:, :8]})
    last, caches = model.prefill(params, {"tokens": toks[:, :8]}, 9)
    step, caches = model.decode_step(params, caches, toks[:, 8:], 8)
    assert logits.dtype == torch.bfloat16 and logits.shape[1] == 8
    assert torch.isfinite(logits).all() and torch.isfinite(step).all()
    torch.testing.assert_close(last[:, 0], logits[:, -1], rtol=0, atol=0)
    loss, _ = model.loss(params, {"tokens": toks[:, :8],
                                  "labels": toks[:, 1:]})
    assert loss.dim() == 0 and torch.isfinite(loss)
