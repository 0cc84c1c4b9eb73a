"""Train-to-serve weight handoff, counterpart of ``repro/serve/handoff.py``.

A training run ends (or snapshots) as a
:class:`~repro_torch.core.replica.ReplicaState` in the layout its
``ShardingPolicy`` dictates: stacked ``(P, ...)`` params, one row a
replica, or FSDP ``(P_eff, n_b)`` shard buffers, one row a pod, in the
gather-all or the layer-streamed (layer-grouped) bucket layout.  The
serving engine wants one params tree in the model's canonical structure,
ready for ``model.prefill`` / ``model.decode_step``.
:func:`serving_weights_from_state` is that bridge
(``replica.consolidate_state``: the replicas' mean, or the pods' mean
unpacked through the plan's shard layout; a streamed state's layered
``{"stem", "layers", "head"}`` tree is merged back to the canonical one
through the model's ``ModelAPI.layered``);
:func:`serving_weights_from_checkpoint` reads a checkpoint's policy from
its manifest, restores the state and consolidates it, so a server picks
weights off disk without knowing how the trainer laid them out.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.checkpoint import ckpt
from repro_torch.core import replica as replica_mod


def _merge_if_layered(tree, plan, model):
    streamed = (plan is not None and plan.sharding.is_sharded
                and plan.sharding.streamed)
    if not streamed:
        return tree
    if model is None or model.layered is None:
        raise ValueError(
            "a streamed-fsdp state consolidates into the layered tree; "
            "pass model= (with ModelAPI.layered) to merge it back to the "
            "canonical structure")
    return model.layered.merge(tree)


def serving_weights_from_state(state: replica_mod.ReplicaState, *,
                               plan=None, model=None):
    """Consolidate a ReplicaState into serving params (on the state's
    device).  ``plan`` is the AveragingPlan the state was trained under,
    required for an FSDP state (it owns the shard layout); ``model`` is the
    ``ModelAPI``, required for a streamed state (its ``layered`` merges the
    layered tree)."""
    tree = replica_mod.consolidate_state(state, plan)
    return _merge_if_layered(tree, plan, model)


def serving_weights_from_checkpoint(path: str, template, *, plan=None,
                                    model=None,
                                    layered: Optional[object] = None):
    """Load a replica-state checkpoint as serving params (CPU tensors).

    ``template`` is the restoring layout's ReplicaState of tensors or
    ``Spec`` leaves (as ``load_replica_state`` takes it); the checkpoint's
    own policy comes from its manifest.  ``plan`` (the compiled sharded
    plan) is required for an FSDP checkpoint, ``model`` (or ``layered``)
    for a streamed one.
    """
    sharding = ckpt.checkpoint_sharding(path)
    layered = layered or (model.layered if model is not None else None)
    state = ckpt.load_replica_state(path, template, sharding=sharding,
                                    plan=plan, layered=layered)
    tree = replica_mod.consolidate_state(
        state, plan if sharding.is_sharded else None)
    if sharding.is_sharded and sharding.streamed:
        tree = _merge_if_layered(tree, plan, model)
    return tree
