"""Train-to-serve weight handoff, counterpart of ``repro/serve/handoff.py``.

A training run ends (or snapshots) as a
:class:`~repro_torch.core.replica.ReplicaState` in the layout its
``ShardingPolicy`` dictates: stacked ``(P, ...)`` params, one row a
replica, or FSDP ``(P_eff, n_b)`` shard buffers, one row a pod.  The
serving engine wants one params tree in the model's canonical structure,
ready for ``model.prefill`` / ``model.decode_step``.
:func:`serving_weights_from_state` is that bridge
(``replica.consolidate_state``: the replicas' mean, or the pods' mean
unpacked through the plan's shard layout);
:func:`serving_weights_from_checkpoint` reads a checkpoint's policy from
its manifest, restores the state and consolidates it, so a server picks
weights off disk without knowing how the trainer laid them out.

The layer-streamed state belongs to slice 7b and raises, naming it.
"""

from __future__ import annotations

from repro_torch.checkpoint import ckpt
from repro_torch.core import replica as replica_mod


def serving_weights_from_state(state: replica_mod.ReplicaState, *,
                               plan=None):
    """Consolidate a ReplicaState into serving params (on the state's
    device).  ``plan`` is the AveragingPlan the state was trained under,
    required for an FSDP state (it owns the shard layout)."""
    return replica_mod.consolidate_state(state, plan)


def serving_weights_from_checkpoint(path: str, template, *, plan=None):
    """Load a replica-state checkpoint as serving params (CPU tensors).

    ``template`` is the restoring layout's ReplicaState of tensors or
    ``Spec`` leaves (as ``load_replica_state`` takes it); the checkpoint's
    own policy comes from its manifest.  ``plan`` (the compiled sharded
    plan) is required for an FSDP checkpoint.
    """
    sharding = ckpt.checkpoint_sharding(path)
    state = ckpt.load_replica_state(path, template, sharding=sharding,
                                    plan=plan)
    return replica_mod.consolidate_state(
        state, plan if sharding.is_sharded else None)
