"""Checkpointing: trees of tensors -> .npz with flattened key paths + a JSON
manifest, in the JAX package's format.

Counterpart of ``repro/checkpoint/ckpt.py``, replicated surface, in its
format: the same key paths (dict keys, sequence indices and ``.field`` for
a NamedTuple field, joined by ``/``, as ``jax.tree_util`` spells them), the
same arrays (bfloat16 widened to float32, since npz has none), the same
crc32 per leaf and the same manifest, so a checkpoint written by either
package loads into the other with identical arrays and checksums.  Leaves
cross as numpy.

WAGMA keeps *divergent* per-replica weights (leading dp axis);
``consolidate`` averages the replica axis into one model, the paper's
"global consensus achieved post-training by choosing the model average".

Writes are **atomic** (DESIGN.md §13): every file lands on a temp path, is
flushed and fsynced, then rename-committed; the manifest, carrying a crc32
per stored leaf, is written last, so a crash mid-save leaves either the
previous complete checkpoint or a torn write that :func:`load_checkpoint`
rejects loudly, never a half-written state that loads silently.

:func:`save_replica_state` / :func:`load_replica_state` round-trip a whole
:class:`~repro_torch.core.replica.ReplicaState` (stacked ``(P, ...)``
params and optimiser state, or FSDP ``(P_eff, n_b)`` shard buffers; step,
phase and the policy), and restore across the replicated, FSDP and
layer-streamed FSDP policies through the host-side conversions of
``core/replica.py``.

Over a model axis (``launch/mesh.py``) a checkpoint holds whole leaves:
``Trainer.save_checkpoint`` gathers every rank's slices on rank 0
(``mesh.gather_model_slices``), so the files are those a model-1 run of
the same state writes, and ``Trainer(init_state=...)`` cuts a restored
state into the rank's slices by the placement rule; a checkpoint moves
between model axes of any size.
"""

from __future__ import annotations

import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree as tr

# rename-commit seam; the crash-mid-save tests monkeypatch this to die
# between the data files and the manifest
_replace = os.replace


class ChecksumError(RuntimeError):
    """A stored leaf's bytes do not match the manifest's checksum."""


def _checksum(arr: np.ndarray) -> int:
    """crc32 of the array's C-order bytes (read in place, not copied)."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _checksums(arrays) -> List[int]:
    """:func:`_checksum` of each array on 8 threads (zlib lets go of the
    GIL over large buffers)."""
    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(_checksum, arrays))


def _atomic_savez(path: str, flat: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    _replace(tmp, path)


def _atomic_write_text(path: str, text: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    _replace(tmp, path)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _visit(node, prefix: Tuple[str, ...], out: list) -> None:
    """Append ``(key path, leaf)`` of ``node`` in JAX's flatten order."""
    if node is None:
        return
    if isinstance(node, tr.Spec):
        out.append(("/".join(prefix), node))
    elif isinstance(node, dict):
        for k in sorted(node):
            _visit(node[k], prefix + (str(k),), out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f, child in zip(node._fields, node):
            _visit(child, prefix + (f".{f}",), out)
    elif isinstance(node, (tuple, list)):
        for i, child in enumerate(node):
            _visit(child, prefix + (str(i),), out)
    else:
        out.append(("/".join(prefix), node))


def _leaves_with_paths(tree) -> List[Tuple[str, object]]:
    out: list = []
    _visit(tree, (), out)
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:   # npz has no bf16: widen to f32
            leaf = leaf.float()
        return leaf.numpy()
    return np.asarray(leaf)


def _flatten(tree) -> dict:
    return {key: _to_numpy(leaf) for key, leaf in _leaves_with_paths(tree)}


def save_checkpoint(path: str, params, opt_state=None, step: int = 0,
                    metadata: Optional[dict] = None):
    """Atomic save: data files first, checksummed manifest last (the
    manifest's rename is the commit point)."""
    os.makedirs(path, exist_ok=True)
    flat = _flatten(params)
    _atomic_savez(os.path.join(path, "params.npz"), flat)
    manifest = {
        "step": int(step),
        "keys": sorted(flat),
        "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        "shapes": {k: list(v.shape) for k, v in flat.items()},
        "checksums": dict(zip(flat, _checksums(flat.values()))),
        "metadata": metadata or {},
    }
    if opt_state is not None:
        opt_flat = _flatten(opt_state)
        _atomic_savez(os.path.join(path, "opt_state.npz"), opt_flat)
        manifest["opt_checksums"] = dict(zip(opt_flat,
                                             _checksums(opt_flat.values())))
    _atomic_write_text(os.path.join(path, "manifest.json"),
                       json.dumps(manifest, indent=2))
    _fsync_dir(path)


def _rebuild(path: str, template, npz, checksums):
    """``template``'s structure filled from ``npz``: each leaf verified
    against the manifest's crc32 (checkpoints predating the checksums load
    unverified), then a CPU tensor in the template leaf's dtype."""
    keys, arrays = [], []
    for key, leaf in _leaves_with_paths(template):
        arr = npz[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"checkpoint {path!r} leaf {key!r} has shape "
                             f"{arr.shape}, the template {tuple(leaf.shape)}")
        keys.append((key, leaf.dtype))
        arrays.append(arr)
    if checksums is not None:
        for (key, _), arr, got in zip(keys, arrays, _checksums(arrays)):
            if key in checksums and got != checksums[key]:
                raise ChecksumError(
                    f"checkpoint {path!r} leaf {key!r}: stored bytes hash "
                    f"{got}, manifest says {checksums[key]} — torn or "
                    "corrupted write")
    leaves = [torch.from_numpy(arr).to(dtype)
              for (_, dtype), arr in zip(keys, arrays)]
    return tr.tree_unflatten(tr.tree_flatten(template)[1], leaves)


def load_checkpoint(path: str, params_template, opt_template=None):
    """Restore into the structure of the given templates (tensors or
    :class:`~repro_torch.core.tree.Spec` leaves); a leaf whose bytes do not
    match the manifest raises :class:`ChecksumError`.  Returns ``(params,
    step)``, or ``(params, opt_state, step)`` with an ``opt_template``."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "params.npz")) as data:
        params = _rebuild(path, params_template, data,
                          manifest.get("checksums"))
    step = manifest["step"]
    if opt_template is None:
        return params, step
    with np.load(os.path.join(path, "opt_state.npz")) as data:
        opt = _rebuild(path, opt_template, data,
                       manifest.get("opt_checksums"))
    return params, opt, step


def consolidate(stacked_params):
    """Average the leading dp-replica axis -> single consensus model."""
    return tr.tree_map(lambda a: a.float().mean(0).to(a.dtype),
                       stacked_params)


# ---------------------------------------------------------------------------
# ReplicaState round trip
# ---------------------------------------------------------------------------

def save_replica_state(path: str, state, sharding=None,
                       metadata: Optional[dict] = None):
    """Persist a whole ReplicaState (params, opt, step/phase, policy)."""
    from repro_torch.core.replica import REPLICATED
    sharding = sharding or REPLICATED
    meta = dict(metadata or {})
    meta.update({
        "replica_state": True,
        "phase": int(state.phase),
        "sharding": sharding.kind,
        "shard_axis": sharding.shard_axis,
        "streamed": sharding.streamed,
    })
    save_checkpoint(path, state.params, opt_state=state.opt_state,
                    step=int(state.step), metadata=meta)


def checkpoint_sharding(path: str):
    """The ShardingPolicy a replica-state checkpoint was written under."""
    from repro_torch.core.replica import ShardingPolicy
    with open(os.path.join(path, "manifest.json")) as f:
        meta = json.load(f)["metadata"]
    return ShardingPolicy(meta.get("sharding", "replicated"),
                          meta.get("shard_axis"),
                          meta.get("streamed", False))


def _read_state(path: str, src_template):
    """The ReplicaState stored at ``path``, rebuilt into ``src_template``
    (the layout it was written in)."""
    from repro_torch.core import replica as replica_mod
    params, opt, step = load_checkpoint(path, src_template.params,
                                        src_template.opt_state)
    with open(os.path.join(path, "manifest.json")) as f:
        phase = json.load(f)["metadata"].get("phase", -1)
    return replica_mod.ReplicaState(params, opt, step=int(step),
                                    phase=int(phase))


def load_replica_state(path: str, template, *, sharding=None, plan=None,
                       layered=None):
    """Restore a ReplicaState into ``template``'s layout (its params and
    optimiser state: tensors or Specs).

    ``sharding`` is the *restoring run's* policy (default replicated).
    When it differs from the policy the checkpoint was written under, the
    state is rebuilt in the source layout (from ``plan``, the compiled
    sharded AveragingPlan of the model, required for any cross-policy
    restore) and converted: pod models broadcast to their members (FSDP ->
    replicated) or pod-averaged and packed (replicated -> FSDP).

    When the streamed layout is on either side, ``layered`` (the model's
    ``ModelAPI.layered``) is also required: streamed plans store the
    layered tree ``{"stem", "layers", "head"}`` while replicated
    checkpoints hold the canonical tree, so the restore merges or splits
    each replica row across the structures (pure restructuring, bit for
    bit).
    """
    from repro_torch.core import replica as replica_mod
    sharding = sharding or replica_mod.REPLICATED
    src = checkpoint_sharding(path)
    if src.kind == sharding.kind and src.streamed != sharding.streamed:
        # both FSDP in different bucket layouts (streamed vs gather-all):
        # one plan cannot describe both, and the npz keys are flat bucket
        # indices, so route through the canonical replicated layout
        return _load_across_stream_layouts(path, template, src, sharding,
                                           plan, layered)
    needs_layered = (src.kind != sharding.kind
                     and (src.streamed or sharding.streamed))
    if needs_layered and layered is None:
        raise ValueError(
            f"converting between {src.describe()} and {sharding.describe()}"
            " crosses the layered <-> canonical tree structures; pass "
            "layered= (the model's ModelAPI.layered)")
    if src.kind == sharding.kind:
        src_template = template
    elif plan is None:
        raise ValueError(
            f"checkpoint at {path} was written under {src.describe()} but "
            f"the run uses {sharding.describe()}; pass the compiled plan "
            "to convert")
    elif src.is_sharded:
        src_template = replica_mod.sharded_state_template(
            plan, template.opt_state)
    else:
        # replicated checkpoints hold the canonical tree; a streamed
        # plan's replicated template is layered, so canonicalise it
        src_template = replica_mod.replicated_state_template(
            plan, template.opt_state)
        if sharding.streamed:
            src_template = replica_mod.canonical_replicated_template(
                src_template, layered)
    state = _read_state(path, src_template)
    if src.kind == sharding.kind:
        return state
    if src.is_sharded:
        state = replica_mod.fsdp_to_replicated_state(state, plan)
        if src.streamed:
            state = replica_mod.merge_layered_state(state, layered)
        return state
    if sharding.streamed:
        state = replica_mod.split_layered_state(state, layered)
    return replica_mod.replicated_to_fsdp_state(state, plan)


def _load_across_stream_layouts(path, template, src, sharding, plan,
                                layered):
    """Streamed <-> gather-all FSDP restore through the canonical
    replicated layout.

    ``plan`` is the RESTORING run's plan.  The source layout's plan is
    compiled here on the same topology and config with the streamed bit
    flipped; the state loads in the source layout, converts to the
    replicated layout, crosses the layered <-> canonical structures when
    the two plans were compiled over different trees (``layered``
    required; ``None`` when both plans share one tree structure), and
    converts back under the destination plan.  Restructuring and the
    pod mean of identical members: bit for bit.
    """
    from repro_torch.core import replica as replica_mod
    from repro_torch.core.plan import compile_plan

    if plan is None:
        raise ValueError(
            f"checkpoint at {path} was written under {src.describe()} but "
            f"the run uses {sharding.describe()}; pass the compiled plan "
            "to convert across the bucket layouts")
    src_policy = replica_mod.ShardingPolicy.fsdp_within_pod(
        src.shard_axis or sharding.shard_axis, streamed=src.streamed)
    if layered is None:
        src_tree = plan.storage_struct
    elif src.streamed:
        # the destination (gather-all) holds the canonical tree; the
        # source stored the layered one
        src_tree = layered.split(plan.storage_struct)
    else:
        src_tree = layered.merge(plan.storage_struct)
    src_plan = compile_plan(plan.topology, src_tree, plan.cfg, src_policy)
    state = _read_state(path, replica_mod.sharded_state_template(
        src_plan, template.opt_state))
    state = replica_mod.fsdp_to_replicated_state(state, src_plan)
    if layered is not None:
        state = (replica_mod.merge_layered_state(state, layered)
                 if src.streamed else
                 replica_mod.split_layered_state(state, layered))
    return replica_mod.replicated_to_fsdp_state(state, plan)
