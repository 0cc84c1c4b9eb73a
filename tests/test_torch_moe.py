"""The moe family (``models/moe.py``: llama4-maverick, kimi-k2) against the
JAX package, on the CPU in float32 from the same numpy inputs, for both
configs' smoke variants.

- ``router_topk``: the same expert indices, gate and both aux losses to
  ``ROUTER_TOL``; also rows of exactly equal logits (``jax.lax.top_k``
  puts the lower index first) and a wider E = 64, k = 8 router.
- ``moe_ffn`` under ``slotmap``, ``onehot_scatter`` and ``shardmap``
  (each the slot map in the port, which computes the function of every
  JAX path on one device), with drops (capacity factor 0.25) and without
  (64): ``dropped`` equal exactly, the output to ``FFN_TOL`` of its
  largest entry; an unknown name is refused.
- ``forward``'s logits and aux to ``TOL``.
- ``prefill`` caches and logits, then 3 ``decode_step``s, against the JAX
  ones to ``TOL``; decode against the port's own ``forward`` to
  ``DECODE_TOL`` with drop-free capacity (the JAX package's
  ``test_decode_matches_forward``).
- The loss (router aux included) and its gradient for every leaf against
  ``jax.value_and_grad`` of the JAX ``model.loss`` to ``TOL``, with the
  plain cross-entropy (the smoke vocab) and the chunked one (a vocab of
  65536), remat on and off.

Weights come from the JAX init and cross as numpy (``params_from_jax``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as jmoe
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.core import tree as tr
from repro_torch.models import moe, registry
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import build_prefill, build_serve_step

ARCHS = ["llama4-maverick-400b-a17b", "kimi-k2-1t-a32b"]
ROUTER_TOL = 1e-6      # gate and aux losses, absolute
FFN_TOL = 1e-5         # moe_ffn output, of its largest entry
TOL = 1e-4             # logits, caches, loss, each gradient leaf (of its max)
DECODE_TOL = 2e-3      # prefill + decode vs forward, rtol and atol
BIG = 65536            # the chunked cross-entropy's switch
DROPS, DROPLESS = 0.25, 64.0


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=tol,
                               atol=tol * scale)


def _cfgs(arch, **kw):
    return (get_config(arch, smoke=True).variant(dtype="float32", **kw),
            jax_config(arch, smoke=True).variant(dtype="float32", **kw))


def _to_torch(tree):
    return tr.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)),
                       jax.tree.map(np.asarray, tree))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    cfg, jcfg = _cfgs(request.param)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = registry.build_model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jm, jparams, model, params


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------

def _router_case(cfg, jcfg, logits):
    jidx, jgate, jaux = jmoe.router_topk(jcfg, jnp.asarray(logits))
    idx, gate, aux = moe.router_topk(cfg, torch.from_numpy(logits))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=0,
                               atol=ROUTER_TOL)
    assert set(aux) == set(jaux) == {"load_balance", "router_z"}
    for name in aux:
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=ROUTER_TOL, atol=ROUTER_TOL)
    return idx


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "E64-k8"])
def test_router_topk_matches_jax(arch, wide):
    kw = {"n_experts": 64, "top_k": 8} if wide else {}
    cfg, jcfg = _cfgs(arch, **kw)
    logits = (np.random.default_rng(0).standard_normal(
        (40, cfg.n_experts)) * 1.7).astype(np.float32)
    _router_case(cfg, jcfg, logits)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("wide", [False, True], ids=["smoke", "E64-k8"])
def test_router_topk_ties_take_the_lower_index(arch, wide):
    """Rows of exactly equal logits (a zero input to the router), rows
    with a tie across the k-th place and rows tied in pairs."""
    kw = {"n_experts": 64, "top_k": 8} if wide else {}
    cfg, jcfg = _cfgs(arch, **kw)
    E, k = cfg.n_experts, cfg.top_k
    rng = np.random.default_rng(1)
    zero = np.zeros((3, E), np.float32)
    edge = np.zeros((4, E), np.float32)
    edge[:, ::2] = 1.0          # E/2 tied leaders, more than k of them
    pairs = np.repeat(rng.standard_normal((5, E // 2)), 2,
                      axis=1).astype(np.float32)
    idx = _router_case(cfg, jcfg, np.concatenate([zero, edge, pairs]))
    assert idx[0].tolist() == list(range(k))
    assert idx[3].tolist() == list(range(0, 2 * k, 2))


# ---------------------------------------------------------------------------
# The MoE FFN
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def ffn(request):
    cfg, jcfg = _cfgs(request.param)
    jp = jmoe.init_moe_ffn(jcfg, jax.random.PRNGKey(0), jnp.float32)
    h = (np.random.default_rng(1).standard_normal((2, 32, cfg.d_model))
         * 0.5).astype(np.float32)
    return cfg, jcfg, jp, _to_torch(jp), h


@pytest.mark.parametrize("impl", ["slotmap", "onehot_scatter", "shardmap"])
@pytest.mark.parametrize("cf", [DROPS, DROPLESS], ids=["drops", "dropless"])
def test_moe_ffn_matches_jax(ffn, impl, cf):
    cfg, jcfg, jp, p, h = ffn
    cfg, jcfg = (c.variant(moe_impl=impl, capacity_factor=cf)
                 for c in (cfg, jcfg))
    jout, jaux = jmoe.moe_ffn(jcfg, jp, jnp.asarray(h))
    out, aux = moe.moe_ffn(cfg, p, torch.from_numpy(h))
    dropped = float(aux["dropped"])
    assert dropped == float(jaux["dropped"])
    assert (dropped > 0) == (cf == DROPS)
    _close(out, jout, FFN_TOL)
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=ROUTER_TOL, atol=ROUTER_TOL)


def test_moe_ffn_refuses_an_unknown_impl(ffn):
    cfg, _, _, p, h = ffn
    with pytest.raises(ValueError, match="unknown moe_impl"):
        moe.moe_ffn(cfg.variant(moe_impl="dense"), p, torch.from_numpy(h))


def test_recording_dropped_logs_each_call_inside_the_block(ffn):
    cfg, _, _, p, h = ffn
    cfg = cfg.variant(capacity_factor=DROPS)
    with moe.recording_dropped() as log:
        _, aux = moe.moe_ffn(cfg, p, torch.from_numpy(h))
        with moe.recording_dropped() as inner:
            moe.moe_ffn(cfg, p, torch.from_numpy(h))
    moe.moe_ffn(cfg, p, torch.from_numpy(h))
    assert len(log) == 1 and len(inner) == 1
    assert float(log[0]) == float(aux["dropped"]) > 0


def test_decode_capacity_and_chunks():
    """A decode step at B < 8 runs one chunk at capacity 8; a prefill's
    chunk count falls until it divides T."""
    cfg = get_config("kimi-k2-1t-a32b")
    assert moe._chunking(cfg, 4, 8) == (1, 8)
    assert moe._chunking(cfg, 4 * 512, None) == (8, 53)
    assert moe._chunking(cfg, 4 * 543, None) == (6, 56)
    assert moe._chunking(get_config("llama4-maverick-400b-a17b"), 4 * 512,
                         None) == (8, 20)
    with pytest.raises(ValueError, match="moe_impl"):
        moe.moe_ffn(cfg.variant(moe_impl="dense"), {}, torch.zeros(1, 1, 1))


# ---------------------------------------------------------------------------
# Model: forward, serving, loss
# ---------------------------------------------------------------------------

def test_forward_matches_jax(pair):
    cfg, jm, jparams, model, params = pair
    toks = _tokens(cfg, 2, 16, 0)
    want, jaux = jm.forward(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = model.forward(params, {"tokens": torch.as_tensor(
        toks, dtype=torch.int64)})
    assert tuple(got.shape) == want.shape
    _close(got, want, TOL)
    assert set(aux) == set(jaux) == {"load_balance", "router_z", "dropped"}
    assert float(aux["dropped"]) == float(jaux["dropped"])
    for name in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=TOL, atol=TOL)


def test_prefill_and_decode_match_jax(pair):
    """Prefill 8 tokens with room for 12 through ``build_prefill``, then 3
    decode steps, each against the JAX package's on the same caches."""
    cfg, jm, jparams, model, params = pair
    toks = _tokens(cfg, 2, 12, 1)
    jl, jc = jm.prefill(jparams, {"tokens": jnp.asarray(toks[:, :8])}, 12)
    tl, tc = build_prefill(model, 12)(params, {"tokens": torch.as_tensor(
        toks[:, :8], dtype=torch.int64)})
    _close(tl, jl, TOL)
    jleaves, tleaves = jax.tree.leaves(jc), tr.tree_leaves(tc)
    assert len(jleaves) == len(tleaves) == (4 if cfg.first_dense else 2)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape
        _close(t, j, TOL)
    assert tr.tree_map(lambda a: tuple(a.shape), model.init_caches(2, 12)) \
        == tr.tree_map(lambda a: tuple(a.shape), tc)
    step = jax.jit(jm.decode_step)
    for t in range(8, 11):
        jl, jc = step(jparams, jc, jnp.asarray(toks[:, t:t + 1]),
                      jnp.asarray(t))
        tl, tc = model.decode_step(params, tc, torch.as_tensor(
            toks[:, t:t + 1], dtype=torch.int64), t)
        _close(tl, jl, TOL)
        for j, c in zip(jax.tree.leaves(jc), tr.tree_leaves(tc)):
            _close(c, j, TOL)


def test_decode_matches_forward(pair):
    """prefill(8) + 4 decode steps reproduce the forward's logits at drop-
    free capacity (drops legally differ between a 12-token forward and
    the prefill's and decode steps' pools)."""
    cfg, _, _, _, params = pair
    model = registry.build_model(cfg.variant(capacity_factor=DROPLESS),
                                 device="cpu")
    toks = torch.as_tensor(_tokens(cfg, 2, 12, 2), dtype=torch.int64)
    full, aux = model.forward(params, {"tokens": toks})
    assert float(aux["dropped"]) == 0.0
    logits, caches = build_prefill(model, 12)(params, {"tokens": toks[:, :8]})
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, 7].numpy(),
                               rtol=DECODE_TOL, atol=DECODE_TOL)
    step = build_serve_step(model)
    for t in range(8, 12):
        _, logits, caches = step(params, caches, toks[:, t:t + 1], t)
        np.testing.assert_allclose(
            logits[:, 0, :cfg.vocab].numpy(), full[:, t, :cfg.vocab].numpy(),
            rtol=DECODE_TOL, atol=DECODE_TOL, err_msg=f"pos={t}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("vocab,remat", [(None, True), (None, False),
                                         (BIG, True), (BIG, False)],
                         ids=["plain-remat", "plain", "chunked-remat",
                              "chunked"])
def test_loss_and_grads_match_jax_value_and_grad(arch, vocab, remat):
    kw = {"vocab": vocab} if vocab else {}
    cfg, jcfg = _cfgs(arch, **kw)
    assert (cfg.vocab_padded >= registry.CHUNKED_CE_VOCAB) == bool(vocab)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    toks = _tokens(cfg, 2, 17, 3)
    mask = (np.random.default_rng(4).random((2, 16)) > 0.2).astype(
        np.float32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:], "mask": mask}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p, b: jm.loss(p, b, remat=remat), has_aux=True)(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    model = registry.build_model(cfg, device="cpu")
    leaves, treedef = tr.tree_flatten(params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), "cpu"))
    leaves = [l.requires_grad_(True) for l in leaves]
    tbatch = {k: torch.as_tensor(v, dtype=torch.int64 if v.dtype.kind == "i"
                                 else torch.float32)
              for k, v in batch.items()}
    loss, metrics = model.loss(tr.tree_unflatten(treedef, leaves), tbatch,
                               remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL, atol=TOL)
    assert set(metrics) == set(jmet) == {"ce", "load_balance", "router_z",
                                         "moe_dropped", "loss"}
    for name in metrics:
        np.testing.assert_allclose(metrics[name].item(), float(jmet[name]),
                                   rtol=TOL, atol=TOL, err_msg=name)
    assert metrics["loss"].item() > metrics["ce"].item()
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        _close(g, jg, TOL)


def test_moe_trees_match_jax_at_published_size():
    """The full-size trees: JAX's shapes leaf for leaf (``eval_shape``),
    a float32 router, and caches grouped ``first``/``blocks``."""
    for arch in ARCHS:
        cfg = get_config(arch)
        want = jax.eval_shape(lambda: jmoe.init_params(
            jax_config(arch), jax.random.PRNGKey(0)))
        assert jax.tree.map(lambda a: tuple(a.shape), want) == \
            moe.param_shapes(cfg)
        specs = moe.param_specs(cfg)
        assert specs["blocks"]["moe"]["moe"]["router"].dtype == torch.float32
        assert specs["blocks"]["moe"]["moe"]["we1"].dtype == torch.bfloat16
        caches = registry.build_model(cfg, device="meta").init_caches(4, 544)
        n_sb, per = moe.layout(cfg)
        assert tuple(caches["blocks"]["k"].shape) == (n_sb, per, 4, 544, 8,
                                                      cfg.hd)
        assert ("first" in caches) == bool(cfg.first_dense)
    assert get_config("kimi-k2-1t-a32b").hd == 112


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_trains_at_smoke_size_and_logs_router_metrics(arch):
    """``python -m repro_torch.launch.train --arch ... --smoke`` on the
    CPU trains WAGMA replicas of the moe model and logs the router's
    metrics beside each loss."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src, REPRO_TORCH_DEVICE="cpu",
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--data-axis", "4", "--group-size", "2", "--tau", "3",
         "--steps", "4", "--seq-len", "32", "--global-batch", "8"],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "final loss" in out.stdout
    logged = [l for l in out.stdout.splitlines() if l.startswith("step")]
    assert len(logged) == 2
    for line in logged:
        words = line.split()
        for name in ("load_balance", "router_z", "moe_dropped"):
            assert np.isfinite(float(words[words.index(name) + 1])), line
