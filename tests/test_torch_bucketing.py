"""The port's bucket layouts against the JAX package's, and pack/unpack.

A layout is a function of one replica's tree structure and the budget; the
port must lay out the same tree exactly as JAX does (leaf order, bucket
boundaries, offsets, 128-element padding, dtype grouping), since the
butterfly's exactness against the JAX plan rests on it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.core import bucketing as jb
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.core import bucketing as tb
from repro_torch.core import tree as tr
from repro_torch.models import transformer as tfm

# (path, shape, dtype): dict keys out of sorted order, nested dicts, a
# tuple, mixed dtypes, a lane-unaligned leaf, a scalar, empty leaves
LEAVES = {
    "w": ((33, 7), "float32"), "b": ((130,), "float32"),
    "emb": ((64, 100), "bfloat16"), "s": ((), "float32"),
    "e": ((0, 4), "float32"), "z": {"k": ((5, 5), "bfloat16"),
                                     "a": ((2, 3, 4), "float32")},
    "t": (((7,), "float32"), ((0,), "bfloat16"), ((300,), "float32")),
}


def _build(node, leaf):
    if isinstance(node, dict):
        return {k: _build(v, leaf) for k, v in node.items()}
    if isinstance(node[0], tuple) and isinstance(node[1], str):
        return leaf(*node)
    return tuple(_build(c, leaf) for c in node)


def _jax_tree():
    return _build(LEAVES, lambda shape, dt: jax.ShapeDtypeStruct(
        shape, getattr(jnp, dt)))


def _torch_tree():
    return _build(LEAVES, lambda shape, dt: tr.Spec(shape, getattr(torch, dt)))


def _dt(d) -> str:
    return str(d).replace("torch.", "") if isinstance(d, torch.dtype) \
        else np.dtype(d).name


def _same_layout(tl, jl):
    assert tl.bucket_sizes == jl.bucket_sizes
    assert [_dt(d) for d in tl.bucket_dtypes] == \
        [_dt(d) for d in jl.bucket_dtypes]
    assert len(tl.slots) == len(jl.slots)
    for a, b in zip(tl.slots, jl.slots):
        assert (a.bucket, a.offset, a.size, a.shape, _dt(a.dtype)) == \
            (b.bucket, b.offset, b.size, b.shape, _dt(b.dtype))


@pytest.mark.parametrize("budget", [64, 512, 1000, 4096, 32 << 20])
def test_layout_identical_to_jax(budget):
    tl = tb.build_layout(_torch_tree(), max_bucket_bytes=budget)
    jl = jb.build_layout(_jax_tree(), max_bucket_bytes=budget)
    _same_layout(tl, jl)
    assert tl.n_buckets == jl.n_buckets
    assert tb.tree_payload_bytes(_torch_tree()) == \
        jb.tree_payload_bytes(_jax_tree())


def test_layout_of_the_slice_model_identical_to_jax():
    """tinyllama-1.1b at full width, 6 layers, cast to float32 (the plan's
    work tree) at the budgets around the slice's 64 MiB."""
    cfg = get_config("tinyllama-1.1b").variant(n_layers=6)
    jshapes = jax.eval_shape(
        jax_build(jax_config("tinyllama-1.1b").variant(n_layers=6)).init,
        jax.random.PRNGKey(0))
    jwork = jax.tree.map(lambda s: jax.ShapeDtypeStruct(s.shape, jnp.float32),
                         jshapes)
    twork = tr.tree_map(lambda s: tr.Spec(s.shape, torch.float32),
                        tfm.param_specs(cfg))
    for budget in (32 << 20, 64 << 20, 128 << 20):
        _same_layout(tb.build_layout(twork, max_bucket_bytes=budget),
                     jb.build_layout(jwork, max_bucket_bytes=budget))


def test_pack_unpack_round_trip_stacked_and_padded():
    rng = np.random.default_rng(0)
    P = 4
    tree = _build(LEAVES, lambda shape, dt: torch.from_numpy(
        rng.standard_normal((P,) + shape).astype(np.float32)).to(
            getattr(torch, dt)))
    layout = tb.layout_for(tr.struct(tree, drop=1), max_bucket_bytes=1000)
    bufs = tb.pack(tree, layout)
    assert [tuple(b.shape) for b in bufs] == [(P, n) for n in
                                              layout.bucket_sizes]
    assert all(n % 128 == 0 for n in layout.bucket_sizes)
    back = tb.unpack(bufs, layout)
    for a, b in zip(tr.tree_leaves(tree), tr.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    # the pad region is zero, and every bucket is a new buffer
    for buf, slots in zip(bufs, range(layout.n_buckets)):
        used = sum(s.size for s in layout.slots if s.bucket == slots)
        assert torch.count_nonzero(buf[:, used:]) == 0
    # cast while packing == pack then cast
    f32 = tb.pack(tree, layout, dtype=torch.float32)
    for a, b in zip(f32, bufs):
        assert a.dtype == torch.float32 and torch.equal(a, b.float())
    # an unstacked tree packs into 1-D buckets of the same layout
    one = tr.tree_map(lambda a: a[1], tree)
    for a, b in zip(tb.pack(one, layout), bufs):
        assert torch.equal(a, b[1])


def test_tree_map_buckets_uses_one_replicas_layout():
    P = 2
    tree = {"a": torch.arange(P * 300, dtype=torch.float32).reshape(P, 300),
            "b": torch.ones((P, 3, 3), dtype=torch.bfloat16)}
    seen = []

    def fn(bufs):
        seen.extend((tuple(b.shape), b.dtype) for b in bufs)
        return [b * 2 for b in bufs]

    out = tb.tree_map_buckets(fn, tree, max_bucket_bytes=1 << 20)
    assert seen == [((P, 384), torch.float32), ((P, 128), torch.float32)]
    assert torch.equal(out["a"], tree["a"] * 2)
    assert out["b"].dtype == torch.bfloat16
    assert torch.equal(out["b"], tree["b"] * 2)
    out = tb.tree_map_bucketed(lambda b: b + 1, tree, compute_dtype=None)
    assert torch.equal(out["a"], tree["a"] + 1)


def test_layout_cache_and_budget_sweep_match_jax():
    tb.clear_layout_cache()
    t = _torch_tree()
    first = tb.layout_for(t, max_bucket_bytes=512)
    assert tb.layout_for(t, max_bucket_bytes=512) is first
    assert tb.layout_cache_stats() == {"hits": 1, "misses": 1}
    tb.layout_for(t, max_bucket_bytes=1024)
    assert tb.layout_cache_stats()["misses"] == 2
    for payload in (1, 5 << 20, 300 << 20, 1580 << 20):
        for P, S, tau in ((8, 4, 5), (64, 8, 10), (16, 2, 1)):
            assert tb.choose_bucket_bytes(payload, P=P, S=S, tau=tau) == \
                jb.choose_bucket_bytes(payload, P=P, S=S, tau=tau)
    tb.clear_layout_cache()
    assert tb.layout_cache_stats() == {"hits": 0, "misses": 0}


def test_buffers_are_freed_without_the_cycle_collector():
    """Flattening, unflattening and a bucketed mix leave no reference
    cycle: the float32 buckets and the input leaves die with their last
    reference, so peak memory does not wait on Python's cycle collector."""
    import gc
    import weakref

    tree = {"a": torch.ones(4, 33), "b": {"c": torch.ones(4, 7, 5).to(
        torch.bfloat16), "d": (torch.ones(4, 3), None)}}
    seen = []

    def mix(bufs):
        seen.extend(weakref.ref(b) for b in bufs)
        return [b * 2.0 for b in bufs]

    gc.disable()
    try:
        gc.collect()
        out = tb.tree_map_buckets(mix, tree, max_bucket_bytes=256)
        leaves = [weakref.ref(l) for l in tr.tree_leaves(tree)]
        del tree
        assert len(seen) >= 2 and all(r() is None for r in seen)
        assert all(r() is None for r in leaves)
        assert tr.tree_unflatten(*reversed(tr.tree_flatten(out))) is not out
        assert gc.collect() == 0
    finally:
        gc.enable()
