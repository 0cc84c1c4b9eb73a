"""internvl2-2b (``models/vlm.py``: the dense transformer after a prefix of
patch embeddings) against the JAX package, on the CPU in float32 from the
same numpy inputs.

- ``forward`` with patches against the JAX ``vlm.forward`` to ``TOL`` of
  the largest logit, over all n_patches + S positions.
- ``prefill`` through the serving path's ``build_prefill`` and four
  ``decode_step``s at absolute positions (prefix included) against the JAX
  forward's logits to ``DECODE_TOL`` (the JAX package's
  ``test_decode_matches_forward``), and the prefill's caches against JAX's.
- The prefix changes the text's logits (``tests/test_models.py``'s
  ``test_vlm_prefix_changes_text_logits``).
- The loss over the text positions and its gradient for every leaf against
  ``jax.value_and_grad`` of the JAX ``model.loss``, with the plain
  cross-entropy (the smoke vocab) and the chunked one (a vocab of 65536,
  as internvl2-2b's 92553 padded takes), remat on and off.

Weights come from the JAX init and cross as numpy (``params_from_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.core import tree as tr
from repro_torch.models import registry, vlm
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import build_prefill, build_serve_step

ARCH = "internvl2-2b"
TOL = 1e-5             # forward, of the largest logit
DECODE_TOL = 2e-3      # prefill + decode vs forward, rtol and atol
RTOL = 1e-5            # the loss
GRAD_RTOL = 1e-4       # each gradient leaf, of its largest entry
BIG = 65536            # the chunked cross-entropy's switch


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def _cfgs(**kw):
    return (get_config(ARCH, smoke=True).variant(dtype="float32", **kw),
            jax_config(ARCH, smoke=True).variant(dtype="float32", **kw))


def _batch(cfg, b, s, seed):
    """numpy tokens (B,S) int32 and patches (B,Np,d) float32."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
            "patches": (rng.standard_normal((b, cfg.n_patches, cfg.d_model))
                        * 0.5).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype.kind == "i"
                               else torch.float32) for k, v in batch.items()}


@pytest.fixture(scope="module")
def pair():
    cfg, jcfg = _cfgs()
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = registry.build_model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jm, jparams, model, params


def test_forward_with_patches_matches_jax(pair):
    cfg, jm, jparams, model, params = pair
    batch = _batch(cfg, 2, 12, 0)
    want, _ = jm.forward(jparams, _jax(batch))
    got, aux = model.forward(params, _torch(batch))
    assert aux == {} and tuple(got.shape) == want.shape
    assert got.shape[1] == cfg.n_patches + 12
    _close(got, want, TOL)


def test_prefill_decode_match_jax_forward(pair):
    """Prefill the patches and 8 tokens with room for 12, then decode 4 at
    positions n_patches + 8 .. n_patches + 11; the caches hold the prefix."""
    cfg, jm, jparams, model, params = pair
    T, T0, npch = 12, 8, cfg.n_patches
    batch = _batch(cfg, 2, T, 1)
    full, _ = jm.forward(jparams, _jax(batch), remat=False)
    full = np.asarray(full)
    pre = dict(batch, tokens=batch["tokens"][:, :T0])
    jl, jc = jm.prefill(jparams, _jax(pre), T)
    tl, tc = build_prefill(model, T)(params, _torch(pre))
    np.testing.assert_allclose(tl[:, 0].numpy(), full[:, npch + T0 - 1],
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    jleaves, tleaves = jax.tree.leaves(jc), tr.tree_leaves(tc)
    assert len(jleaves) == len(tleaves) == 2
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape and t.shape[2] == npch + T
        _close(t, j, TOL)
    assert tr.tree_map(lambda a: tuple(a.shape), model.init_caches(2, T)) \
        == tr.tree_map(lambda a: tuple(a.shape), tc)
    step = build_serve_step(model)
    for t in range(T0, T):
        tok = torch.as_tensor(batch["tokens"][:, t:t + 1], dtype=torch.int64)
        _, logits, tc = step(params, tc, tok, npch + t)
        np.testing.assert_allclose(
            logits[:, 0, :cfg.vocab].numpy(), full[:, npch + t, :cfg.vocab],
            rtol=DECODE_TOL, atol=DECODE_TOL, err_msg=f"text pos={t}")


def test_prefix_changes_text_logits(pair):
    cfg, _, _, model, params = pair
    batch = _torch(_batch(cfg, 1, 8, 2))
    l1, _ = model.forward(params, batch)
    l2, _ = model.forward(params, dict(batch, patches=-batch["patches"]))
    assert l1.shape[1] == cfg.n_patches + 8
    assert not torch.allclose(l1[:, -1], l2[:, -1])
    # with the prefix's positions the text starts at n_patches
    plain = tfm.forward(cfg, params, batch["tokens"])
    assert not torch.allclose(plain[:, -1], l1[:, -1])


@pytest.mark.parametrize("vocab,remat", [(None, True), (None, False),
                                         (BIG, True), (BIG, False)],
                         ids=["plain-remat", "plain", "chunked-remat",
                              "chunked"])
def test_loss_and_grads_match_jax_value_and_grad(vocab, remat):
    kw = {"vocab": vocab} if vocab else {}
    cfg, jcfg = _cfgs(**kw)
    assert (cfg.vocab_padded >= registry.CHUNKED_CE_VOCAB) == bool(vocab)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    b = _batch(cfg, 2, 17, 3)
    batch = {"tokens": b["tokens"][:, :-1], "labels": b["tokens"][:, 1:],
             "patches": b["patches"],
             "mask": (rng.random((2, 16)) > 0.2).astype(np.float32)}
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p, bt: jm.loss(p, bt, remat=remat), has_aux=True)(
            jparams, _jax(batch))
    model = registry.build_model(cfg, device="cpu")
    leaves, treedef = tr.tree_flatten(params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), "cpu"))
    leaves = [l.requires_grad_(True) for l in leaves]
    loss, metrics = model.loss(tr.tree_unflatten(treedef, leaves),
                               _torch(batch), remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL,
                               atol=RTOL)
    assert metrics["ce"] is metrics["loss"]
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        _close(g, jg, GRAD_RTOL)


def test_internvl2_tree_and_caches_are_the_dense_ones():
    """The full-size config: the dense tree (untied ``lm_head``, 8 KV
    heads of 128) and caches of max_len + n_patches positions."""
    cfg = get_config(ARCH)
    assert (cfg.hd, cfg.n_kv_heads, cfg.vocab_padded) == (128, 8, 92672)
    specs = vlm.param_specs(cfg)
    assert specs == tfm.param_specs(cfg) and "lm_head" in specs
    caches = registry.build_model(cfg, device="meta").init_caches(4, 544)
    assert tuple(caches["global"]["k"].shape) == (24, 4, 544 + 256, 8, 128)
