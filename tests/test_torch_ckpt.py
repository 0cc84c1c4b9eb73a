"""The port's checkpoints (``repro_torch/checkpoint/ckpt.py``): the
counterparts of the JAX package's checkpoint tests
(tests/test_optim_data_ckpt.py) on the port's trees, and the format held
to the JAX package's both ways: a ``ReplicaState`` written by the JAX
package loads into the port and is written back with identical arrays,
keys, crc32s and manifest, and one written by the port loads into the JAX
package with identical arrays."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_replica_state as jax_load_replica_state
from repro.checkpoint import save_replica_state as jax_save_replica_state
from repro.core.replica import ReplicaState as JState
from repro.optim.sgd import SGDState as JSGDState
from repro_torch.checkpoint import (ChecksumError, checkpoint_sharding,
                                    consolidate, load_checkpoint,
                                    load_replica_state, save_checkpoint,
                                    save_replica_state)
from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.core import tree as tr
from repro_torch.core.faults import InjectedCrash
from repro_torch.core.replica import REPLICATED, ReplicaState
from repro_torch.optim.sgd import SGDState


def test_checkpoint_roundtrip_and_consolidate(tmp_path):
    tree = {
        "emb": torch.from_numpy(np.random.default_rng(0).standard_normal(
            (4, 8)).astype(np.float32)).to(torch.bfloat16),
        "blocks": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)},
    }
    opt = {"m": torch.ones((4, 8), dtype=torch.float32)}
    save_checkpoint(str(tmp_path), tree, opt_state=opt, step=42,
                    metadata={"arch": "test"})
    restored, ropt, step = load_checkpoint(str(tmp_path), tree, opt)
    assert step == 42
    for a, b in zip(tr.tree_leaves(restored), tr.tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(ropt["m"], opt["m"])
    # a template of Specs restores the same tensors
    specs = tr.struct(tree)
    again, _ = load_checkpoint(str(tmp_path), specs)
    for a, b in zip(tr.tree_leaves(again), tr.tree_leaves(tree)):
        assert torch.equal(a, b)

    stacked = {"w": torch.stack([torch.zeros(3), torch.ones(3) * 2.0]),
               "h": torch.tensor([[1.0, 3.0]], dtype=torch.bfloat16)}
    cons = consolidate(stacked)
    assert cons["w"].tolist() == [1.0, 1.0, 1.0]
    assert cons["h"].dtype == torch.bfloat16 and cons["h"].tolist() == \
        [1.0, 3.0]


def test_consolidate_matches_jax():
    rng = np.random.default_rng(3)
    arr = rng.standard_normal((4, 5, 6)).astype(np.float32)
    got = consolidate({"a": torch.from_numpy(arr)})["a"].numpy()
    want = np.asarray(jax.jit(lambda a: jnp.mean(a, axis=0))(arr))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _tiny_ckpt():
    params = {"w": torch.arange(6, dtype=torch.float32),
              "b": {"x": torch.ones((2, 3), dtype=torch.bfloat16)}}
    opt = {"m": torch.zeros((6,), dtype=torch.float32)}
    return params, opt


def test_atomic_save_leaves_no_tmp_files(tmp_path):
    params, opt = _tiny_ckpt()
    save_checkpoint(str(tmp_path), params, opt_state=opt, step=1)
    assert sorted(os.listdir(tmp_path)) == ["manifest.json",
                                            "opt_state.npz", "params.npz"]


def test_corrupted_leaf_bytes_fail_the_checksum(tmp_path):
    params, opt = _tiny_ckpt()
    save_checkpoint(str(tmp_path), params, opt_state=opt, step=1)
    stored = dict(np.load(tmp_path / "params.npz"))
    raw = stored["w"].view(np.uint8).copy()
    raw[5] ^= 0x10                                    # one flipped bit
    stored["w"] = raw.view(np.float32)
    np.savez(tmp_path / "params.npz", **stored)
    with pytest.raises(ChecksumError, match="torn or corrupted"):
        load_checkpoint(str(tmp_path), params, opt)


def test_crash_before_manifest_commit_preserves_previous_checkpoint(
        tmp_path, monkeypatch):
    """Killed between the data renames and the manifest's: the new data
    under the old manifest is refused; a retried save commits and wins."""
    params, opt = _tiny_ckpt()
    newer = tr.tree_map(lambda a: a * 3 + 1, params)
    d = str(tmp_path)
    save_checkpoint(d, params, opt_state=opt, step=1)
    real_replace = ckpt_mod._replace

    def crash_on_manifest(src, dst):
        if dst.endswith("manifest.json"):
            raise InjectedCrash("killed between data and manifest rename")
        real_replace(src, dst)

    monkeypatch.setattr(ckpt_mod, "_replace", crash_on_manifest)
    with pytest.raises(InjectedCrash):
        save_checkpoint(d, newer, opt_state=opt, step=2)
    monkeypatch.setattr(ckpt_mod, "_replace", real_replace)
    with pytest.raises(ChecksumError):
        load_checkpoint(d, params, opt)
    save_checkpoint(d, newer, opt_state=opt, step=2)
    restored, _, step = load_checkpoint(d, params, opt)
    assert step == 2 and torch.equal(restored["w"], newer["w"])


def test_crash_before_any_rename_leaves_no_checkpoint_at_all(
        tmp_path, monkeypatch):
    params, opt = _tiny_ckpt()

    def crash(src, dst):
        raise InjectedCrash("killed before the first rename")

    monkeypatch.setattr(ckpt_mod, "_replace", crash)
    with pytest.raises(InjectedCrash):
        save_checkpoint(str(tmp_path), params, opt_state=opt, step=1)
    assert all(f.endswith(".tmp") for f in os.listdir(tmp_path))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), params, opt)


def test_pre_checksum_checkpoints_still_load(tmp_path):
    params, opt = _tiny_ckpt()
    save_checkpoint(str(tmp_path), params, opt_state=opt, step=7)
    mpath = tmp_path / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest.pop("checksums")
    manifest.pop("opt_checksums")
    mpath.write_text(json.dumps(manifest))
    restored, _, step = load_checkpoint(str(tmp_path), params, opt)
    assert step == 7 and torch.equal(restored["w"], params["w"])


def _port_state(P=2):
    rng = np.random.default_rng(1)
    params = {"emb": torch.from_numpy(rng.standard_normal(
                  (P, 5, 3)).astype(np.float32)).to(torch.bfloat16),
              "layers": {"w": torch.from_numpy(rng.standard_normal(
                  (P, 4)).astype(np.float32))}}
    mom = tr.tree_map(lambda a: a.float() * 0.5, params)
    return ReplicaState(params, SGDState(mom, torch.tensor([3, 4],
                                                           dtype=torch.int32)),
                        step=7, phase=1)


def test_replica_state_round_trip_is_checksum_verified(tmp_path):
    state = _port_state()
    d = str(tmp_path)
    save_replica_state(d, state, metadata={"arch": "x"})
    assert checkpoint_sharding(d) == REPLICATED
    back = load_replica_state(d, ReplicaState(tr.struct(state.params),
                                              tr.struct(state.opt_state)))
    assert (back.step, back.phase) == (7, 1)
    for a, b in zip(tr.tree_leaves((back.params, back.opt_state)),
                    tr.tree_leaves((state.params, state.opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    stored = dict(np.load(tmp_path / "params.npz"))
    stored["layers/w"] = stored["layers/w"] * 2
    np.savez(tmp_path / "params.npz", **stored)
    with pytest.raises(ChecksumError):
        load_replica_state(d, state)


def test_an_fsdp_checkpoint_raises_naming_the_fsdp_slice(tmp_path):
    """An FSDP manifest now restores (tests/test_torch_fsdp.py); across
    policies only with the sharded plan.  A streamed manifest names its
    policy and restores under it (tests/test_torch_streaming.py crosses
    it to the other policies); across the layered <-> canonical structures
    only with ``layered=``."""
    from repro_torch.core.replica import FSDP_SLICE, ShardingPolicy
    save_replica_state(str(tmp_path), _port_state())
    mpath = tmp_path / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["metadata"].update(sharding="fsdp_within_pod",
                                shard_axis="data")
    mpath.write_text(json.dumps(manifest))
    assert checkpoint_sharding(str(tmp_path)) == \
        ShardingPolicy.fsdp_within_pod("data")
    with pytest.raises(ValueError, match="pass the compiled plan"):
        load_replica_state(str(tmp_path), _port_state())
    manifest["metadata"].update(streamed=True)
    mpath.write_text(json.dumps(manifest))
    streamed = ShardingPolicy.fsdp_within_pod("data", streamed=True)
    assert checkpoint_sharding(str(tmp_path)) == streamed
    back = load_replica_state(str(tmp_path), _port_state(),
                              sharding=streamed)
    assert (back.step, back.phase) == (7, 1)
    for a, b in zip(tr.tree_leaves((back.params, back.opt_state)),
                    tr.tree_leaves((_port_state().params,
                                    _port_state().opt_state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="layered="):
        load_replica_state(str(tmp_path), _port_state())
    assert "slice 7c" in FSDP_SLICE


def _files(d):
    out = {}
    for f in ("params.npz", "opt_state.npz"):
        with np.load(os.path.join(d, f)) as z:
            out[f] = [(k, z[k].dtype.str, z[k]) for k in z]
    return out, json.loads(open(os.path.join(d, "manifest.json")).read())


def _assert_same_files(a, b):
    (fa, ma), (fb, mb) = _files(a), _files(b)
    assert ma == mb                       # keys, shapes, dtypes, crc32s
    for f in fa:
        assert [(k, t) for k, t, _ in fa[f]] == [(k, t) for k, t, _ in fb[f]]
        for (_, _, x), (_, _, y) in zip(fa[f], fb[f]):
            np.testing.assert_array_equal(x, y)


def test_jax_replica_state_loads_into_the_port_and_back(tmp_path):
    rng = np.random.default_rng(2)
    params = {"emb": jnp.asarray(rng.standard_normal((2, 5, 3)),
                                 jnp.bfloat16),
              "layers": [{"w": jnp.asarray(rng.standard_normal((2, 4)),
                                           jnp.float32)}]}
    mom = jax.tree.map(lambda a: a.astype(jnp.float32) * 0.5, params)
    jstate = JState.create(params, JSGDState(mom, jnp.asarray([5, 6],
                                                              jnp.int32)),
                           step=9, phase=0)
    src, dst = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_save_replica_state(src, jax.device_get(jstate), metadata={"arch": "t"})
    template = ReplicaState(
        {"emb": tr.Spec((2, 5, 3), torch.bfloat16),
         "layers": [{"w": tr.Spec((2, 4), torch.float32)}]},
        SGDState({"emb": tr.Spec((2, 5, 3), torch.float32),
                  "layers": [{"w": tr.Spec((2, 4), torch.float32)}]},
                 tr.Spec((2,), torch.int32)))
    state = load_replica_state(src, template)
    assert (state.step, state.phase) == (9, 0)
    assert state.params["emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(state.params["emb"].float().numpy(),
                                  np.asarray(params["emb"], np.float32))
    assert state.opt_state.count.tolist() == [5, 6]
    save_replica_state(dst, state, metadata={"arch": "t"})
    _assert_same_files(src, dst)


def test_port_replica_state_loads_into_jax_and_back(tmp_path):
    state = _port_state()
    src, dst = str(tmp_path / "port"), str(tmp_path / "jax")
    save_replica_state(src, state, metadata={"arch": "t"})
    jtemplate = JState.create(
        {"emb": jnp.zeros((2, 5, 3), jnp.bfloat16),
         "layers": {"w": jnp.zeros((2, 4), jnp.float32)}},
        JSGDState({"emb": jnp.zeros((2, 5, 3), jnp.float32),
                   "layers": {"w": jnp.zeros((2, 4), jnp.float32)}},
                  jnp.zeros((2,), jnp.int32)))
    back = jax_load_replica_state(src, jtemplate)
    assert (int(back.step), int(back.phase)) == (7, 1)
    np.testing.assert_array_equal(
        np.asarray(back.params["emb"], np.float32),
        state.params["emb"].float().numpy())
    np.testing.assert_array_equal(np.asarray(back.opt_state.count), [3, 4])
    jax_save_replica_state(dst, jax.device_get(back), metadata={"arch": "t"})
    _assert_same_files(src, dst)
