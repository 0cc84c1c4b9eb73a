"""The port's model axis for the moe family (llama4-maverick, kimi-k2: the
expert-parallel ``moe_ffn``, the reference's ``shardmap`` path, with one
float32 all-reduce of (Tc, d) a chunk) against the JAX package on
Auto-typed ``(data, model)`` meshes (ROADMAP.md F1), on the CPU in float32,
at the smoke configs (4 experts; llama4 top-1, 2 layers; kimi top-2, 3
layers).

Three JAX subprocesses (training of each model, serving;
``tests/model_axis_runs.py``) and two gloo worlds run side by side, all
from the same port-made inputs:

- training, world ``data 2 x model 2``: 3 WAGMA steps at S 2 and tau 2
  from one initial state against the JAX Trainer on a ``(2, 2)`` mesh
  (whose ``shardmap`` path routes each replica's tokens): losses within
  1e-6 relative, the gathered params and momenta within 1e-5 of each
  leaf's largest magnitude; the leaves held whole bit-identical over each
  model group; the router's gather summing its gradient over the ranks
  (llama4: top-1, so its router learns from the aux losses alone) and
  the gates without ``copy_to_model`` (kimi) must fail the comparison;
- serving, worlds ``data 2 x model 2`` and ``data 1 x model 2``: prefill
  and 4 greedy decode steps against the reference's ``build_serve_step``
  with ``serve_param_shardings``/``cache_shardings``, logits within 1e-5
  and the tokens equal: over two data ranks each routes its own rows, as
  the reference's ``shardmap`` path routes each data shard;
- the routed combine: one all-reduce a chunk, ``routed`` in
  ``common.tp_stats``;
- placement: every leaf's split dim is the one the reference's sharding
  cuts (smoke and published configs at model 2 and 4), but the smoke
  configs' 2 KV heads at model 4, held whole; ``cache_shardings``' dp
  entries are the reference's;
- refusal: serving over two data ranks where the reference routes the
  whole batch raises;
- init: a rank's init is ``take_slices`` of the whole init, bit for bit.
"""

import numpy as np
import pytest
import torch

import model_axis_runs as mar
import rank_runs
from jax_trainer_runs import one_torch_thread  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.core import tree as tr
from repro_torch.models import common as cm
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import (build_prefill, build_serve_step,
                                      cache_shardings)

LLAMA4, KIMI = "llama4-maverick-400b-a17b", "kimi-k2-1t-a32b"
ARCHS = (LLAMA4, KIMI)
# name -> (arch, planted fault)
RUNS = {"llama4": (LLAMA4, None), "kimi": (KIMI, None),
        "llama4_router_gather_summed": (LLAMA4, "router_gather_summed"),
        "kimi_gate_unsummed": (KIMI, "gate_unsummed")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("moe_model_axis"))
    return out, mar.run_all(out, ARCHS, RUNS)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "published"])
@pytest.mark.parametrize("arch", ARCHS)
def test_placement_is_the_reference_sharding(runs, arch, smoke):
    """At model 2 and 4 every leaf the reference's
    ``serve_param_shardings`` cuts on a dim is one the port's ``placement``
    splits on that dim, and every other leaf is held whole, but for the
    smoke configs' KV projections at model 4, whose 2 KV heads the port
    holds whole: the experts by expert, the router by column (its
    experts'), the shared expert by ``d_ff``."""
    out, _ = runs
    cfg = get_config(arch, smoke=smoke)
    for n_model in mar.PLACEMENT_MODELS:
        want = mar.shard_shapes(out)[f"{arch}|{smoke}|{n_model}"]
        shapes = mar.flat(moe.param_shapes(cfg))
        dims = mar.flat(cm.placement(cfg, moe.param_shapes(cfg), n_model))
        assert sorted(shapes) == sorted(want)
        for path, shape in shapes.items():
            cut = [i for i, (a, b) in enumerate(zip(shape, want[path]))
                   if a != b]
            if path.split("/")[-1] in ("wk", "wv") \
                    and cfg.n_kv_heads < n_model:
                assert (dims[path], cut) == (None, [len(shape) - 1]), path
            else:
                assert dims[path] == (cut[0] if cut else None), \
                    (path, n_model)
        m = "blocks/moe/moe"
        assert [dims[f"{m}/{n}"] for n in ("we1", "we3", "we2", "router")] \
            == [1, 1, 1, 2]
        assert (dims[f"{m}/shared/w1"], dims[f"{m}/shared/w2"]) == (2, 1)


def test_cache_shardings_dp_entries_equal_the_reference(runs):
    """The ``first`` and ``blocks`` KV caches (smoke and published) on each
    mesh and batch: the port's dp entries are the reference's, and where
    the reference raises the port raises the same ``ValueError``; the
    model entry sits on the KV-head dim where the heads divide."""
    out, _ = runs
    want = mar.cache_specs(out)
    checked = raised = 0
    for arch in ARCHS:
        for smoke in (True, False):
            cfg = get_config(arch, smoke=smoke)
            for (data, n_model), batch, max_len in mar.CACHE_CASES:
                key = f"{arch}|{smoke}|{data}x{n_model}|{batch}|{max_len}"
                shapes = moe.init_caches(cfg, batch, max_len, "meta")
                mesh = {"data": data, "model": n_model}
                if "error" in want[key]:
                    with pytest.raises(ValueError) as e:
                        cache_shardings(mesh, shapes, batch)
                    assert str(e.value) == want[key]["error"]
                    raised += 1
                    continue
                got = mar.flat(cache_shardings(mesh, shapes, batch))
                assert sorted(got) == sorted(want[key])
                for path, w in want[key].items():
                    node = got[path]
                    w = [None if e == "model" else e for e in w]
                    w += [None] * (len(node) - len(w))
                    assert [None if e == "model" else e for e in node] == w, \
                        (key, path)
                    if node[-2] != "data":                 # the KV heads
                        assert (node[-2] == "model") == (
                            cfg.n_kv_heads % n_model == 0
                            and cfg.n_kv_heads >= n_model)
                    checked += 1
    assert checked and raised


@pytest.mark.parametrize("name", ["llama4", "kimi"])
def test_data2_model2_trainer_matches_jax_trainer(runs, name):
    """llama4 and kimi over data 2 x model 2, each rank with its 2 of the
    4 experts, hold to the JAX Trainer's shardmap path; the leaves held
    whole are bit-identical over each model group, and the gathered
    checkpoint restores at model 2 bit for bit."""
    out, ranks = runs
    ranks = ranks[(2, 2)]
    assert mar.parting(out, ranks, name, RUNS[name][0]) == []
    mar.held_whole_and_restored(ranks, name)


@pytest.mark.parametrize("name", ["llama4_router_gather_summed",
                                  "kimi_gate_unsummed"])
def test_router_gradient_faults_fail_the_jax_comparison(runs, name):
    """The router's gathered logits whose gradient sums over the ranks
    (each rank's router columns then learn ``mw.size`` times too fast) and
    gates without ``copy_to_model`` (each rank's combine reaches only its
    own experts' gates) part from the JAX run."""
    out, ranks = runs
    assert mar.parting(out, ranks[(2, 2)], name, RUNS[name][0]) != []


@pytest.mark.parametrize("world", mar.SERVE_WORLDS,
                         ids=[f"data{d}xmodel{m}" for d, m in
                              mar.SERVE_WORLDS])
@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_jax_serve_step(runs, arch, world):
    out, ranks = runs
    mar.check_serving(out, ranks, arch, world)


def test_routed_combine_is_one_all_reduce_a_chunk(tmp_path):
    """A kimi moe layer's prefill over 2 model ranks makes one ``routed``
    all-reduce a chunk (``moe_chunks`` 2) and the same logits as one rank:
    the rank computes only its experts."""
    res = rank_runs.spawn("routed_count", 2, str(tmp_path), data=1, model=2,
                          arch=KIMI)
    cfg = mar.smoke(KIMI)
    n_moe = moe.layout(cfg)[0]
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(2))
    tokens = torch.from_numpy(np.arange(16).reshape(2, 8) % cfg.vocab)
    want, _ = build_prefill(model, 8)(params, {"tokens": tokens})
    for r in res:
        assert int(r["routed"]) == n_moe * cfg.moe_chunks
        np.testing.assert_allclose(r["logits"], want.numpy(), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_vocab_parallel_loss_and_grads_match_one_rank(arch,
                                                              tmp_path):
    """At a vocabulary of 65,536 words (the published configs' 163,840
    and 202,048 take the same branch) the loss is the chunked
    cross-entropy over the rank's vocab columns plus the router's aux
    losses: over 2 model ranks the loss and every leaf's gradient are the
    one-rank run's (its slice), to 1e-5 of the leaf's largest."""
    variant = dict(vocab=65536)
    res = rank_runs.spawn("loss_grads", 2, str(tmp_path), data=1, model=2,
                          arch=arch, variant=variant)
    cfg = mar.smoke(arch).variant(**variant)
    assert cfg.vocab_padded >= 65536
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(3))
    leaves = tr.tree_leaves(params)
    for a in leaves:
        a.requires_grad_(True)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 17))
    loss, metrics = model.loss(params, {
        "tokens": torch.from_numpy(tokens[:, :-1]),
        "labels": torch.from_numpy(tokens[:, 1:])})
    assert "load_balance" in metrics
    grads = dict(zip(mar.flat(moe.param_shapes(cfg)),
                     torch.autograd.grad(loss, leaves)))
    dims = mar.flat(cm.placement(cfg, moe.param_shapes(cfg), 2))
    for rank, r in enumerate(res):
        np.testing.assert_allclose(r["loss"], loss.item(), rtol=1e-6)
        for path, g in grads.items():
            d = dims[path]
            want = g if d is None else g.narrow(
                d, rank * g.shape[d] // 2, g.shape[d] // 2)
            scale = float(want.abs().max()) or 1.0
            np.testing.assert_allclose(r[f"grad/{path}"], want.numpy(),
                                       rtol=0, atol=1e-5 * scale,
                                       err_msg=path)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_over_data_ranks_refuses_whole_batch_routing(arch):
    """Over two data ranks each routes its own rows, the reference's
    shardmap semantics: ``moe_impl`` slotmap or onehot_scatter, no model
    axis, or a model axis that does not divide the experts would route the
    whole batch in the reference, and ``build_prefill`` and
    ``build_serve_step`` raise naming that."""
    cfg = mar.smoke(arch)
    two = cm.ModelWorld(2, 0)
    for kind, c, mw in (("slotmap", cfg.variant(moe_impl="slotmap"), two),
                        ("onehot", cfg.variant(moe_impl="onehot_scatter"),
                         two),
                        ("model 1", cfg, None),
                        ("model 3", cfg.variant(n_experts=4),
                         cm.ModelWorld(3, 0))):
        model = build_model(c, "cpu", model_world=mw)
        for build in (lambda: build_prefill(model, 8, data=2),
                      lambda: build_serve_step(model, data=2)):
            with pytest.raises(ValueError, match="routes the whole batch"):
                build()
        build_prefill(model, 8, data=1)              # one dp rank: fine
    build_prefill(build_model(cfg, "cpu", model_world=two), 8, data=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_sliced_init_equals_take_slices(arch):
    """A model rank draws every matrix as the whole init does and keeps
    only its slice (of an expert leaf its experts' matrices): at model 2
    and 4, ``take_slices`` of the whole init, bit for bit, dtypes too."""
    cfg = mar.smoke(arch)
    whole = build_model(cfg, "cpu").init(torch.Generator().manual_seed(5))
    for n_model in (2, 4):
        dims = cm.placement(cfg, whole, n_model)
        for rank in range(n_model):
            mw = cm.ModelWorld(n_model, rank)
            got = build_model(cfg, "cpu", model_world=mw).init(
                torch.Generator().manual_seed(5))
            want = cm.take_slices(whole, dims, mw)
            for a, b in zip(tr.tree_leaves(got), tr.tree_leaves(want)):
                assert a.dtype == b.dtype and torch.equal(a, b)
            assert got["blocks"]["moe"]["moe"]["we1"].shape[1] == \
                cfg.n_experts // n_model
