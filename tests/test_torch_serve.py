"""The port's paged serving against the JAX package and against itself.

BlockPool is held to the JAX tests' unit and property checks.  The port's
``ServeScheduler`` must give the JAX scheduler's tokens on the same request
sets (ragged admission, bucket-padded decode, recompute preemption) in
float32 on the CPU, and its paged outputs must equal its own dense serving
path.  The JAX reference runs without a mesh.
"""

import jax
import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

import repro.serve.scheduler as jsched
from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.serve import (BlockPool, OutOfBlocks, Request,
                               ServeScheduler, build_paged_decode,
                               build_paged_prefill, build_prefill,
                               build_serve_step, init_paged_pool)
from repro_torch.serve.kv_cache import NULL_BLOCK
from repro_torch.serve.scheduler import FINISHED

RAGGED = [(3, 6), (7, 4), (5, 9), (12, 5)]        # (prompt_len, max_new)
PREEMPT = [(9, 12), (8, 13), (10, 11)]


# ---------------------------------------------------------------------------
# BlockPool allocator
# ---------------------------------------------------------------------------

def test_block_pool_alloc_free_evict():
    pool = BlockPool(n_blocks=8, block_size=4)
    assert pool.n_free == 7                       # block 0 reserved
    tbl = pool.allocate("a", 9)                   # ceil(9/4) = 3 blocks
    assert len(tbl) == 3 and NULL_BLOCK not in tbl
    assert pool.allocate("a", 5) == tbl           # never shrinks
    assert pool.tokens_covered("a") == 9
    pool.allocate("b", 16)
    assert pool.n_free == 0 and not pool.can_allocate("c", 1)
    with pytest.raises(OutOfBlocks):
        pool.allocate("c", 1)
    assert "c" not in pool._tables                # atomic: nothing taken
    assert pool.evict("b") == 4 and pool.evictions == 1
    assert pool.free("a") == 3 and pool.n_free == 7
    pool.check_invariants()


def test_block_pool_padded_table_and_validation():
    pool = BlockPool(n_blocks=6, block_size=2)
    pool.allocate(0, 3)
    padded = pool.padded_table(0, 4)
    assert padded.shape == (4,) and padded.dtype == np.int32
    assert list(padded[:2]) == pool.table(0)
    assert (padded[2:] == NULL_BLOCK).all()
    with pytest.raises(ValueError):
        pool.padded_table(0, 1)
    with pytest.raises(ValueError):
        BlockPool(n_blocks=1, block_size=4)
    with pytest.raises(ValueError):
        BlockPool(n_blocks=4, block_size=0)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 5), st.integers(0, 3),
                          st.integers(1, 40)), max_size=60),
       st.integers(2, 12), st.integers(1, 5))
def test_block_pool_property(ops, n_blocks, block_size):
    """Arbitrary allocate/free/evict interleavings keep every invariant."""
    pool = BlockPool(n_blocks=n_blocks, block_size=block_size)
    for rid, op, n_tokens in ops:
        if op == 0:
            try:
                tbl = pool.allocate(rid, n_tokens)
                assert len(tbl) == pool.blocks_for(pool.tokens_covered(rid))
            except OutOfBlocks:
                pass
        elif op == 1:
            pool.free(rid)
            assert pool.tokens_covered(rid) == 0 and pool.table(rid) == []
        else:
            pool.evict(rid)
        pool.check_invariants()
    for rid in list(pool._tables):
        pool.free(rid)
    assert pool.n_free == n_blocks - 1


# ---------------------------------------------------------------------------
# Scheduler against the JAX scheduler and against the dense path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    name = "qwen3-0.6b"
    jcfg = jax_config(name, smoke=True).variant(dtype="float32")
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    cfg = get_config(name, smoke=True).variant(dtype="float32")
    model = build_model(cfg, device="cpu")
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, model, params


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (l,)).astype(np.int32) for l in lens]


def _serve(sched_cls, req_cls, model, params, prompts, lens, n_blocks):
    sched = sched_cls(model, params, n_blocks=n_blocks, block_size=4,
                      max_blocks_per_req=8, max_batch=4)
    for i, (p, (_, n)) in enumerate(zip(prompts, lens)):
        sched.submit(req_cls(i, p, n))
    return sched, sched.run()


def _dense_reference(model, params, prompt, max_new, s_view):
    """Greedy decode of one request alone on the port's dense path."""
    logits, caches = build_prefill(model, s_view)(
        params, {"tokens": torch.as_tensor(prompt[None], dtype=torch.int64)})
    cols = torch.arange(logits.shape[-1])
    out = [int(torch.where(cols < model.cfg.vocab, logits[0, -1],
                           -1e30).argmax())]
    step = build_serve_step(model)
    while len(out) < max_new:
        nxt, _, caches = step(params, caches, torch.tensor([[out[-1]]]),
                              len(prompt) + len(out) - 1)
        out.append(int(nxt[0, 0]))
    return out


@pytest.mark.parametrize("lens,n_blocks,seed", [(RAGGED, 64, 1),
                                                (PREEMPT, 14, 2)],
                         ids=["ragged", "preemption"])
def test_scheduler_matches_jax_and_dense(models, lens, n_blocks, seed):
    jm, jparams, model, params = models
    prompts = _prompts(model.cfg.vocab, [l for l, _ in lens], seed)
    jsch, want = _serve(jsched.ServeScheduler, jsched.Request, jm, jparams,
                        prompts, lens, n_blocks)
    sched, outs = _serve(ServeScheduler, Request, model, params, prompts,
                         lens, n_blocks)
    assert outs == want
    assert sched.blocks.evictions == jsch.blocks.evictions
    assert sched.decode_shapes_compiled == jsch.decode_shapes_compiled
    assert sched.decode_shapes_compiled <= \
        {(b, 8) for b in sched.batch_buckets}
    if n_blocks == 14:
        assert sched.blocks.evictions > 0
        assert any(r.preemptions for r in sched.finished.values())
    for i, (p, (_, n)) in enumerate(zip(prompts, lens)):
        assert outs[i] == _dense_reference(model, params, p, n, 32)
        assert sched.finished[i].state == FINISHED
    assert sched.blocks.n_free == n_blocks - 1
    sched.blocks.check_invariants()


def test_paged_decode_logits_match_dense_serve_step(models):
    """One ragged paged step (rows at their own positions, one padding row
    on the null block) gives each row the dense step's logits."""
    _, _, model, params = models
    bs, mb = 4, 8
    prompts = _prompts(model.cfg.vocab, [5, 11, 2], 4)
    blocks = BlockPool(32, bs)
    pool = init_paged_pool(model, 32, bs)
    prefill = build_paged_prefill(model, block_size=bs)
    tables = np.zeros((4, mb), np.int64)
    firsts = []
    for i, p in enumerate(prompts):
        blocks.allocate(i, len(p) + 1)
        tables[i] = blocks.padded_table(i, mb)
        pool, first = prefill(params, pool,
                              torch.as_tensor(p[None], dtype=torch.int64),
                              torch.as_tensor(tables[i]))
        firsts.append(int(first))
    tokens = torch.tensor(firsts + [0])
    positions = torch.tensor([len(p) for p in prompts] + [0])
    _, nxt, logits = build_paged_decode(model, block_size=bs)(
        params, pool, torch.as_tensor(tables), tokens, positions)
    step = build_serve_step(model)
    for i, p in enumerate(prompts):
        _, caches = build_prefill(model, mb * bs)(
            params, {"tokens": torch.as_tensor(p[None], dtype=torch.int64)})
        want_next, want, _ = step(params, caches, torch.tensor([[firsts[i]]]),
                                  len(p))
        v = model.cfg.vocab
        np.testing.assert_allclose(logits[i, :v].numpy(),
                                   want[0, -1, :v].numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert int(nxt[i]) == int(want_next[0, 0])


def test_scheduler_eos_and_validation(models):
    _, _, model, params = models
    sched = ServeScheduler(model, params, n_blocks=16, block_size=4,
                           max_blocks_per_req=4, max_batch=2)
    with pytest.raises(ValueError):                # exceeds max context
        sched.submit(Request("big", np.zeros(10, np.int32), 8))
    p = _prompts(model.cfg.vocab, [5], 1)[0]
    ref = _dense_reference(model, params, p, 6, 16)
    sched.submit(Request("e", p, 6, eos_id=ref[2]))
    assert sched.run()["e"] == ref[:3]
    sched2 = ServeScheduler(model, params, n_blocks=3, block_size=4,
                            max_blocks_per_req=4, max_batch=2)
    sched2.submit(Request("x", np.zeros(9, np.int32), 2))
    with pytest.raises(OutOfBlocks):
        sched2.run()


def test_paged_pool_refuses_ring_caches():
    model = build_model(get_config("gemma3-12b", smoke=True), device="cpu")
    with pytest.raises(NotImplementedError, match="global"):
        init_paged_pool(model, 8, 4)


def test_vocab_padding_columns_never_win(models):
    """Every greedy pick masks the table's padding columns (vocab rounded
    up to /256): with those columns rigged to win, the picks still fall on
    the best real token."""
    _, _, model, params = models
    cfg = model.cfg.variant(vocab=500)             # table stays 512 wide
    assert cfg.vocab_padded == model.cfg.vocab_padded
    plain = build_model(cfg, device="cpu")

    def rig(fn):
        def rigged(*args):
            logits, caches = fn(*args)
            boosted = logits.clone()
            boosted[..., cfg.vocab:] += 1e4
            return boosted, caches
        return rigged

    rigged = plain._replace(prefill=rig(plain.prefill),
                            decode_step=rig(plain.decode_step))
    prompt = torch.as_tensor(_prompts(cfg.vocab, [6], 5)[0][None],
                             dtype=torch.int64)
    logits, caches = plain.prefill(params, {"tokens": prompt}, 32)
    want_first = int(logits[0, -1, :cfg.vocab].argmax())

    pool = init_paged_pool(rigged, 16, 4)
    table = torch.arange(1, 9)
    pool, first = build_paged_prefill(rigged, block_size=4)(params, pool,
                                                             prompt, table)
    assert int(first) == want_first
    step_logits, _ = plain.decode_step(params, caches,
                                       torch.tensor([[want_first]]), 6)
    want_next = int(step_logits[0, -1, :cfg.vocab].argmax())
    nxt, _, _ = build_serve_step(rigged)(params, caches,
                                         torch.tensor([[want_first]]), 6)
    assert int(nxt[0, 0]) == want_next
    _, nxt, _ = build_paged_decode(rigged, block_size=4)(
        params, pool, table[None], torch.tensor([want_first]),
        torch.tensor([6]))
    assert int(nxt[0]) == want_next
