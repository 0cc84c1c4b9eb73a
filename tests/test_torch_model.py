"""The port's dense decoder against the JAX package at smoke size in float32.

Weights come from the JAX init and cross as numpy (``params_from_jax``);
tokens come from numpy.  ``forward``, ``prefill`` (last logits and caches)
and four ``decode_step``s must match to 1e-4, with ``pos`` as a scalar and
as a per-row tensor (the paged decode batch, each row at its own position).
The JAX reference runs without a mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model

TOL = 1e-4
# gemma3's smoke config adds the local:global pattern with ring caches
ARCHS = ["qwen3-0.6b", "tinyllama-1.1b", "gemma3-12b"]


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
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape
                                                ).astype(np.int32)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.int64)


def test_forward_matches_jax(pair):
    cfg, jm, jparams, model, params = pair
    toks = _tokens(cfg, (2, 40), 0)
    want, _ = jax.jit(jm.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, _ = model.forward(params, {"tokens": _t(toks)})
    _close(got, want)


def test_prefill_and_scalar_pos_decode_match_jax(pair):
    cfg, jm, jparams, model, params = pair
    s, max_len = 37, 48
    toks = _tokens(cfg, (2, s), 1)
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, max_len))(
        jparams, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill(params, {"tokens": _t(toks)}, max_len)
    _close(tl, jl)
    assert set(tc) == set(jc)
    for group in jc:
        for name in ("k", "v"):
            assert tuple(tc[group][name].shape) == jc[group][name].shape
            _close(tc[group][name], jc[group][name])
    jstep = jax.jit(jm.decode_step)
    feed = _tokens(cfg, (4, 2, 1), 2)
    for t in range(4):
        jl, jc = jstep(jparams, jc, jnp.asarray(feed[t]), jnp.asarray(s + t))
        tl, tc = model.decode_step(params, tc, _t(feed[t]), s + t)
        _close(tl, jl)
    for group in jc:
        _close(tc[group]["k"], jc[group]["k"])


def test_per_row_pos_decode_matches_jax_rows(pair):
    """Two requests with different prompt lengths decode as one batch, each
    row at its own position, and each row equals JAX's B=1 decode."""
    cfg, jm, jparams, model, params = pair
    lens, max_len = (5, 11), 24
    jpf = jax.jit(lambda p, b: jm.prefill(p, b, max_len))
    jstep = jax.jit(jm.decode_step)
    feed = _tokens(cfg, (4, 2), 3)
    want_rows, t_caches = [], []
    for r, n in enumerate(lens):
        toks = _tokens(cfg, (1, n), 10 + r)
        _, jc = jpf(jparams, {"tokens": jnp.asarray(toks)})
        rows = []
        for t in range(4):
            jl, jc = jstep(jparams, jc, jnp.asarray(feed[t, r:r + 1, None]),
                           jnp.asarray(n + t))
            rows.append(np.asarray(jl[0]))
        want_rows.append(rows)
        t_caches.append(model.prefill(params, {"tokens": _t(toks)},
                                      max_len)[1])
    # batch the two B=1 caches: batch is dim 1 of global, dim 2 of local
    caches = {g: {n: torch.cat([c[g][n] for c in t_caches],
                               dim=2 if g == "local" else 1)
                  for n in ("k", "v")} for g in t_caches[0]}
    for t in range(4):
        pos = torch.tensor([lens[0] + t, lens[1] + t])
        tl, caches = model.decode_step(params, caches, _t(feed[t, :, None]),
                                       pos)
        for r in range(2):
            _close(tl[r], want_rows[r][t])


def test_superblock_layout_and_shapes_match_jax():
    from repro.models import transformer as jtfm
    for name in ARCHS:
        for smoke in (True, False):
            cfg = get_config(name, smoke=smoke)
            assert tfm.superblock_layout(cfg) == \
                jtfm.superblock_layout(jax_config(name, smoke=smoke))
    cfg = get_config("tinyllama-1.1b", smoke=True)
    want = jax.eval_shape(lambda: jtfm.init_params(
        jax_config("tinyllama-1.1b", smoke=True), jax.random.PRNGKey(0)))
    assert jax.tree.map(lambda a: tuple(a.shape), want) == \
        tfm.param_shapes(cfg)
    with pytest.raises(ValueError):
        params_from_jax(cfg, {"emb": np.zeros((3, 3))}, "cpu")


def test_other_families_name_their_slice():
    """Every family of the JAX package is ported (the moe family last); a
    family the JAX package does not have is refused by name."""
    model = build_model(get_config("kimi-k2-1t-a32b", smoke=True),
                        device="cpu")
    assert model.cfg.family == "moe" and "router" in \
        model.init(torch.Generator().manual_seed(0))["blocks"]["moe"]["moe"]
    with pytest.raises(ValueError, match="unknown family"):
        build_model(get_config("kimi-k2-1t-a32b", smoke=True).variant(
            family="sparse"), device="cpu")
