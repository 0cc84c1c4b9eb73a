"""The port's encoder-decoder (``models/encdec.py``) against the JAX package
at smoke size in float32, for transformer_wmt (a token encoder over
``src``) and whisper-medium (frame embeddings, ``frames``).

Weights come from the JAX init and cross as numpy (``params_from_jax``);
inputs come from numpy.  ``forward``, the loss and its gradients,
``prefill`` through the serving path's ``build_prefill`` (last logits and
every cache) and four ``decode_step``s must
match to 1e-4 of the largest magnitude.  The JAX reference runs without a
mesh.  Both families' synthetic batches must match byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import InputShape as JShape
from repro.data import make_batch_fn as jax_batch_fn
from repro.models import encdec as jencdec
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core import tree as tr
from repro_torch.data import make_batch_fn
from repro_torch.models import encdec
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.serve import build_prefill

TOL = 1e-4
ARCHS = ["transformer-wmt", "whisper-medium"]
SRC_LEN = 24


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg = get_config(request.param, smoke=True).variant(dtype="float32")
    jm = jax_build(jax_config(request.param, smoke=True).variant(
        dtype="float32"))
    jparams = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jm, jparams, model, params


def _close(got, want):
    """Within TOL of ``want``'s largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=TOL,
                               atol=TOL * scale)


def _batch(cfg, b, s, seed):
    """numpy batch: decoder tokens/labels and the encoder's input."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encoder_frames:
        out["frames"] = (rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)) * 0.02).astype(np.float32)
    else:
        out["src"] = rng.integers(0, cfg.vocab, (b, SRC_LEN)).astype(np.int32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype.kind == "i"
                               else torch.float32) for k, v in batch.items()}


def test_forward_matches_jax(pair):
    cfg, jm, jparams, model, params = pair
    batch = _batch(cfg, 2, 20, 0)
    want, _ = jax.jit(jm.forward)(jparams, _jax(batch))
    got, _ = model.forward(params, _torch(batch))
    _close(got, want)


def test_loss_and_grads_match_jax_value_and_grad(pair):
    cfg, jm, jparams, model, params = pair
    batch = _batch(cfg, 2, 20, 1)
    batch["mask"] = (np.random.default_rng(2).random((2, 20)) > 0.2
                     ).astype(np.float32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jm.loss, has_aux=True))(jparams, _jax(batch))
    for remat in (True, False):
        leaves, treedef = tr.tree_flatten(params_from_jax(
            cfg, jax.tree.map(np.asarray, jparams), "cpu"))
        leaves = [l.requires_grad_(True) for l in leaves]
        loss, metrics = model.loss(tr.tree_unflatten(treedef, leaves),
                                   _torch(batch), remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        _close(loss, float(jloss))
        assert metrics["ce"] is metrics["loss"]
        jleaves = jax.tree.leaves(jgrads)
        assert len(grads) == len(jleaves)
        for g, jg in zip(grads, jleaves):
            _close(g, jg)


def test_prefill_and_decode_match_jax(pair):
    cfg, jm, jparams, model, params = pair
    s, max_len = 13, 24
    batch = _batch(cfg, 2, s, 3)
    del batch["labels"]
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len))(
        jparams, _jax(batch))
    # through the serving path's prefill, which passes the batch through
    tl, tc = build_prefill(model, max_len)(params, _torch(batch))
    _close(tl, jl)
    assert set(tc) == set(jc) == {"self", "cross"}
    for group in jc:
        for name in ("k", "v"):
            assert tuple(tc[group][name].shape) == jc[group][name].shape
            _close(tc[group][name], jc[group][name])
    # the cross caches hold the source's real length
    f = cfg.encoder_frames or SRC_LEN
    assert tc["cross"]["k"].shape[2] == f
    jstep = jax.jit(jm.decode_step)
    feed = np.random.default_rng(4).integers(0, cfg.vocab, (4, 2, 1))
    for t in range(4):
        jl, jc = jstep(jparams, jc, jnp.asarray(feed[t], jnp.int32),
                       jnp.asarray(s + t))
        tl, tc = model.decode_step(params, tc, torch.as_tensor(feed[t]),
                                   s + t)
        _close(tl, jl)
    _close(tc["self"]["k"], jc["self"]["k"])


def _meta_caches(cfg):
    return encdec.init_caches(cfg, 2, 40, device="meta")


def test_params_and_caches_match_jax_structure():
    for name in ARCHS:
        for smoke in (True, False):
            cfg, jcfg = get_config(name, smoke=smoke), jax_config(
                name, smoke=smoke)
            want = jax.eval_shape(lambda: jencdec.init_params(
                jcfg, jax.random.PRNGKey(0)))
            got = tr.tree_map(lambda s: s.shape, encdec.param_specs(cfg))
            assert jax.tree.map(lambda a: tuple(a.shape), want) == got
            jc = jax.eval_shape(lambda: jencdec.init_caches(jcfg, 2, 40))
            tc = tr.tree_map(lambda a: tuple(a.shape), _meta_caches(cfg))
            assert jax.tree.map(lambda a: tuple(a.shape), jc) == tc
    cfg = get_config("transformer-wmt", smoke=True)
    p = params_from_jax(cfg, jax.tree.map(np.asarray, jencdec.init_params(
        jax_config("transformer-wmt", smoke=True), jax.random.PRNGKey(1))),
        "cpu")
    assert len(tr.tree_leaves(p)) == len(tr.tree_leaves(
        encdec.param_specs(cfg)))
    assert p["enc_blocks"]["attn"]["wq"].shape[0] == cfg.encoder_layers
    assert p["dec_blocks"]["cross"]["wo"].shape[0] == cfg.n_layers
    with pytest.raises(ValueError):
        params_from_jax(cfg, {"emb": np.zeros((3, 3))}, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_batches_byte_identical(arch):
    for smoke, seq, gb, seed in ((True, 16, 8, 0), (False, 32, 4, 3)):
        fn = make_batch_fn(get_config(arch, smoke=smoke),
                           InputShape("custom", seq, gb, "train"), seed=seed)
        jfn = jax_batch_fn(jax_config(arch, smoke=smoke),
                           JShape("custom", seq, gb, "train"), seed=seed)
        for step, worker in ((0, 0), (1, 0), (7, 3)):
            a, b = fn(step, worker, gb), jfn(step, worker, gb)
            assert sorted(a) == sorted(b)
            assert ("src" in a) == (arch == "transformer-wmt")
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                assert a[k].tobytes() == b[k].tobytes(), k
