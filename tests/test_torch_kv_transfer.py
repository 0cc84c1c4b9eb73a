"""The port's disaggregated serving (``repro_torch/serve/kv_transfer.py``)
against the JAX package's and against its own colocated scheduler.

On the CPU in float32, qwen3-0.6b smoke with weights from the JAX
``model.init`` (the JAX side without a mesh, as tests/test_torch_serve.py
runs it): the port's ``DisaggregatedScheduler`` gives the tokens of its
own ``ServeScheduler`` and of the JAX ``DisaggregatedScheduler``, with
ragged admission and with recompute preemption, and its decode pool holds
the colocated pool's bytes.  ``TransferStats`` equals the JAX connector's
(requests, blocks, bytes and messages exactly, the modeled seconds to
1e-12 relative); the link pricing (``link_transfer_seconds``,
``choose_class_bucket_bytes(overlap=False)``) and ``Topology.with_measured``
equal the reference's.  The connector round trip is bit-exact for
bfloat16, which has no numpy dtype.
"""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.serve.kv_cache as jkv
import repro.serve.kv_transfer as jxfer
from repro.configs import get_config as jax_config
from repro.core import bucketing as jbucketing
from repro.core import plan as jplan
from repro.models.registry import build_model as jax_build
from repro.serve.scheduler import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core import bucketing
from repro_torch.core import plan
from repro_torch.core import tree as tr
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import build_model
from repro_torch.serve import (DisaggregatedScheduler, InProcessTransport,
                               LinkCostedConnector, Request, ServeScheduler)
from repro_torch.serve import kv_cache
from repro_torch.serve.kv_transfer import KVConnector, kv_payload_bytes

RAGGED = [(3, 6), (7, 4), (5, 9), (12, 5)]        # (prompt_len, max_new)
PREEMPT = [(9, 12), (8, 13), (10, 11)]
STAT_FIELDS = ("requests", "blocks", "payload_bytes", "messages")


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


def _serve(sched_cls, req_cls, model, params, lens, n_blocks, seed, **kw):
    sched = sched_cls(model, params, n_blocks=n_blocks, block_size=4,
                      max_blocks_per_req=8, max_batch=4, **kw)
    rng = np.random.default_rng(seed)
    for i, (l, n) in enumerate(lens):
        sched.submit(req_cls(i, rng.integers(0, model.cfg.vocab, (l,))
                             .astype(np.int32), n))
    return sched, sched.run()


def _assert_stats_equal(got, want):
    for f in STAT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert got.modeled_seconds == pytest.approx(want.modeled_seconds,
                                                rel=1e-12, abs=0)


@pytest.mark.parametrize("lens,n_blocks,seed", [(RAGGED, 64, 1),
                                                (PREEMPT, 14, 2)],
                         ids=["ragged", "preemption"])
def test_disaggregated_matches_colocated_and_jax(models, lens, n_blocks,
                                                 seed):
    jm, jparams, model, params = models
    jsched, want = _serve(jxfer.DisaggregatedScheduler, JRequest, jm,
                          jparams, lens, n_blocks, seed)
    colo, colo_out = _serve(ServeScheduler, Request, model, params, lens,
                            n_blocks, seed)
    prefill_params = tr.tree_map(torch.clone, params)
    sched, outs = _serve(DisaggregatedScheduler, Request, model, params,
                         lens, n_blocks, seed, prefill_params=prefill_params)
    assert outs == colo_out == want
    assert sched.blocks.evictions == colo.blocks.evictions == \
        jsched.blocks.evictions
    assert sched.n_prefills == colo.n_prefills
    stats = sched.connector.stats
    _assert_stats_equal(stats, jsched.connector.stats)
    assert stats.requests == sched.n_prefills     # a re-prefill ships again
    if n_blocks == 14:
        assert sched.blocks.evictions > 0 and stats.requests > len(lens)
    else:
        assert stats.blocks == sum(-(-(l + 1) // 4) for l, _ in lens)
    assert stats.payload_bytes == stats.blocks * kv_payload_bytes(
        model.cfg, 4)
    assert sched.connector.transport.bytes_sent >= stats.payload_bytes
    assert sched.connector.transport.messages_sent == stats.messages
    # the decode pool holds the colocated pool's bytes; only the null
    # block (the colocated prefill's padded-table writes) differs
    for name in ("k", "v"):
        assert torch.equal(sched.pool["global"][name][:, 1:],
                           colo.pool["global"][name][:, 1:])
    assert set(sched.staging) == {"d2h_s", "connector_s", "h2d_s"}
    sched.blocks.check_invariants()


class _LosingConnector(LinkCostedConnector):
    def select(self, rid):
        super().select(rid)
        return None


def test_lost_request_fails(models):
    _, _, model, params = models
    with pytest.raises(RuntimeError, match="lost request 0"):
        _serve(DisaggregatedScheduler, Request, model, params, RAGGED[:1],
               16, 0, connector=_LosingConnector())


def _kv_tree(dtype, shape=(2, 3, 4, 2, 8), seed=0):
    rng = np.random.default_rng(seed)
    return {g: {n: rng.standard_normal(shape).astype(np.float32)
                .astype(dtype) for n in ("k", "v")} for g in ("global",)}


def _torch_tree(tree):
    def conv(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return {g: {n: conv(a) for n, a in leaves.items()}
            for g, leaves in tree.items()}


def _jax_link(link):
    return jplan.LinkClass(link.name, alpha=link.alpha, beta=link.beta,
                           gamma=link.gamma, bucket_bytes=link.bucket_bytes)


@pytest.mark.parametrize("dtype,link_name,message_bytes,shape", [
    (np.float32, "DCN", None, (2, 3, 4, 2, 8)),
    (ml_dtypes.bfloat16, "DCN", None, (2, 3, 4, 2, 8)),
    (np.float32, "ICI", 4096, (4, 5, 4, 2, 8)),
    (ml_dtypes.bfloat16, "DCN", 1000, (22, 7, 16, 4, 64)),
], ids=["f32", "bf16", "f32-4KiB", "bf16-tinyllama-blocks"])
def test_transfer_stats_match_jax_connector(dtype, link_name, message_bytes,
                                            shape):
    tree = _kv_tree(dtype, shape)
    link = getattr(plan, link_name)
    jconn = jxfer.LinkCostedConnector(link=getattr(jplan, link_name),
                                      message_bytes=message_bytes)
    conn = LinkCostedConnector(link=link, message_bytes=message_bytes)
    for rid in range(2):
        jconn.insert(rid, tree, {"n_blocks": shape[1]})
        conn.insert(rid, _torch_tree(tree), {"n_blocks": shape[1]})
    _assert_stats_equal(conn.stats, jconn.stats)
    assert conn.stats.payload_bytes == 2 * 2 * np.prod(shape) * \
        np.dtype(dtype).itemsize
    assert conn.transport.bytes_sent == jconn.transport.bytes_sent
    assert conn.transport.messages_sent == jconn.transport.messages_sent
    if message_bytes:
        assert conn.stats.messages >= 4


@pytest.mark.parametrize("dtype", [ml_dtypes.bfloat16, np.float32])
def test_connector_round_trip_is_bit_exact(dtype):
    """Every bit pattern (NaNs and infinities included) crosses unchanged,
    in the leaf's own dtype; a duplicate insert raises; a request is taken
    once; the wire carries 2 bytes an element for bf16."""
    itemsize = np.dtype(dtype).itemsize
    rng = np.random.default_rng(7)
    ints = {2: np.int16, 4: np.int32}[itemsize]
    raw = {n: rng.integers(np.iinfo(ints).min, np.iinfo(ints).max,
                           (3, 5, 4, 2, 8), dtype=ints) for n in ("k", "v")}
    tdtype = {2: torch.bfloat16, 4: torch.float32}[itemsize]
    tree = {"global": {n: torch.from_numpy(a).view(tdtype)
                       for n, a in raw.items()}}
    transport = InProcessTransport()
    conn = LinkCostedConnector(transport=transport, message_bytes=512)
    conn.insert("r0", tree, {"first": 7})
    with pytest.raises(KeyError):
        conn.insert("r0", tree, {})
    got, meta = conn.select("r0")
    assert meta == {"first": 7}
    for n, a in raw.items():
        leaf = got["global"][n]
        assert leaf.dtype == tdtype
        assert np.array_equal(leaf.view({2: torch.int16,
                                         4: torch.int32}[itemsize]).numpy(),
                              a)
    assert conn.select("r0") is None               # taken exactly once
    conn.insert("r0", tree, {})                   # a re-prefill ships again
    payload = bucketing.tree_payload_bytes(tree)
    assert payload == 2 * raw["k"].size * itemsize
    layout = bucketing.layout_for(tree, max_bucket_bytes=512)
    assert transport.bytes_sent == 2 * itemsize * sum(layout.bucket_sizes)
    assert transport.bytes_sent >= 2 * payload
    assert transport.messages_sent == conn.stats.messages
    assert conn.stats.modeled_seconds == pytest.approx(
        2 * plan.link_transfer_seconds(payload, plan.DCN,
                                       message_bytes=512))


def test_kv_payload_bytes_matches_cache():
    for dtype in ("bfloat16", "float32"):
        cfg = get_config("qwen3-0.6b", smoke=True).variant(dtype=dtype)
        model = build_model(cfg, device="cpu")
        caches = model.init_caches(1, 16)
        assert kv_payload_bytes(cfg, 16) == \
            bucketing.tree_payload_bytes(caches)
        jcfg = jax_config("qwen3-0.6b", smoke=True).variant(dtype=dtype)
        assert kv_payload_bytes(cfg, 16) == jxfer.kv_payload_bytes(jcfg, 16)
        assert kv_payload_bytes(cfg, -3) == 0
    # tinyllama-1.1b: 2 x 22 layers x 4 KV heads x 64 x 2 bytes a token
    assert kv_payload_bytes(get_config("tinyllama-1.1b"), 16) == \
        2 * 22 * 4 * 64 * 2 * 16


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_extract_insert_blocks_match_jax(dtype):
    rng = np.random.default_rng(3)
    pool_np = {"global": {n: rng.standard_normal((2, 9, 4, 2, 8))
                          .astype(np.float32).astype(dtype)
                          for n in ("k", "v")}}
    table = np.array([5, 1, 7], np.int32)
    jpool = jax.tree.map(jax.numpy.asarray, pool_np)
    pool = _torch_tree(pool_np)
    got = kv_cache.extract_blocks(pool, table)
    want = jkv.extract_blocks(jpool, table)
    for n in ("k", "v"):
        assert got["global"][n].device.type == "cpu"
        assert np.array_equal(got["global"][n].float().numpy(),
                              np.asarray(want["global"][n], np.float32))
    # float32 rows written into the pool in its dtype (round to nearest)
    blocks = {"global": {n: rng.standard_normal((2, 3, 4, 2, 8))
                         .astype(np.float32) for n in ("k", "v")}}
    want_pool = jkv.insert_blocks(jpool, table, blocks)
    out = kv_cache.insert_blocks(pool, torch.as_tensor(table), _torch_tree(
        blocks))
    assert out is pool
    for n in ("k", "v"):
        assert pool["global"][n].dtype == _torch_tree(pool_np)[
            "global"][n].dtype
        assert np.array_equal(pool["global"][n].float().numpy(),
                              np.asarray(want_pool["global"][n], np.float32))


LINKS = {
    "default": plan.DEFAULT_LINK,
    "ici": plan.ICI,
    "dcn": plan.DCN,
    "alpha-heavy": plan.LinkClass("t", alpha=1e-3, beta=1e-9),
    "pinned": plan.LinkClass("p", alpha=5e-5, beta=1e-10,
                             bucket_bytes=3 << 20),
}
PAYLOADS = (0, 1, 1000, 1 << 20, (3 << 20) + 5, 9_371_648, int(64e6),
            10 ** 9)


@pytest.mark.parametrize("link_name", list(LINKS))
def test_link_pricing_matches_reference(link_name):
    link = LINKS[link_name]
    jlink = _jax_link(link)
    for payload in PAYLOADS:
        for message_bytes in (None, 1024, 1 << 26):
            assert plan.link_transfer_seconds(
                payload, link, message_bytes=message_bytes) == \
                jplan.link_transfer_seconds(payload, jlink,
                                            message_bytes=message_bytes)
        assert plan.choose_class_bucket_bytes(
            max(payload, 1), link, overlap=False) == \
            jplan.choose_class_bucket_bytes(max(payload, 1), jlink,
                                            overlap=False)
    assert plan.link_transfer_seconds(0, link) == 0.0
    # an alpha-heavy link packs fewer, larger messages than 64 KiB ones
    if link_name == "alpha-heavy":
        assert plan.link_transfer_seconds(int(64e6), link) < \
            plan.link_transfer_seconds(int(64e6), link,
                                       message_bytes=1 << 16)


def _classes(topo):
    return [(l.name, l.alpha, l.beta, l.gamma, l.bucket_bytes)
            for l in topo.link_classes]


def _topologies(mod, dcn_pinned=False):
    dcn = mod.LinkClass("dcn", alpha=50e-6, beta=1e-10,
                        bucket_bytes=1 << 22) if dcn_pinned else mod.DCN
    return {
        "flat": mod.Topology.flat(("data",), (4,)),
        "flat-pod-data": mod.Topology.flat(("data", "pod"), (4, 2),
                                           link=mod.ICI),
        "hierarchical": mod.Topology.hierarchical(("data", "pod"), (4, 2),
                                                  dcn=dcn),
        "unmeasured-class": mod.Topology.hierarchical(("data", "pod"),
                                                      (2, 2), dcn=dcn,
                                                      dcn_axes=("pod",)),
    }


def test_with_measured_matches_reference(tmp_path):
    assert plan.DEFAULT_LINK_CONSTANTS_PATH.endswith("LINK_CONSTANTS.json")
    with open(plan.DEFAULT_LINK_CONSTANTS_PATH) as f:
        assert set(json.load(f)["axes"]) == {"pod", "data"}
    custom = tmp_path / "links.json"
    custom.write_text(json.dumps({"axes": {
        "data": {"alpha": 2e-6, "beta": 3e-11, "ag_alpha": 5e-6,
                 "ag_beta": 1e-11, "gamma": 1e-12},
        "other": {"alpha": 9.0, "beta": 9.0}}}))   # no class reads "other"
    for path in (None, str(custom)):
        for pinned in (False, True):
            got = _topologies(plan, pinned)
            want = _topologies(jplan, pinned)
            for key in got:
                g, w = got[key].with_measured(path), \
                    want[key].with_measured(path)
                assert _classes(g) == _classes(w), (path, pinned, key)
                assert g.axis_class == w.axis_class
                for bit in range(int(np.log2(g.P))):
                    assert g.link_of_bit(bit).name == \
                        w.link_of_bit(bit).name
    # with the custom file the pod class keeps its default constants
    topo = _topologies(plan)["hierarchical"].with_measured(str(custom))
    assert topo.link_classes[1] == plan.DCN
    assert topo.link_classes[0].alpha == 5e-6      # the slower all-gather
    assert topo.link_classes[0].beta == 3e-11      # the slower ppermute
