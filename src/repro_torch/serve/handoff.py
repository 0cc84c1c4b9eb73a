"""Train-to-serve weight handoff, counterpart of ``repro/serve/handoff.py``.

A training run ends (or snapshots) as a
:class:`~repro_torch.core.replica.ReplicaState`: stacked ``(P, ...)``
params, one row a replica.  The serving engine wants one params tree in
the model's canonical structure, ready for ``model.prefill`` /
``model.decode_step``.  :func:`serving_weights_from_state` is that bridge
(the replicas' mean, ``replica.consolidate_state``);
:func:`serving_weights_from_checkpoint` reads a checkpoint's policy from
its manifest, restores the state and consolidates it, so a server picks
weights off disk without knowing how the trainer laid them out.

The FSDP (shard-buffer) and streamed (layered) states belong to the FSDP
slice of the port and raise, naming it.
"""

from __future__ import annotations

from repro_torch.checkpoint import ckpt
from repro_torch.core import replica as replica_mod


def serving_weights_from_state(state: replica_mod.ReplicaState, *,
                               plan=None):
    """Consolidate a replicated ReplicaState into serving params (on the
    state's device).  ``plan`` is the AveragingPlan the state was trained
    under; a sharded one raises (the FSDP slice)."""
    return replica_mod.consolidate_state(state, plan)


def serving_weights_from_checkpoint(path: str, template):
    """Load a replica-state checkpoint as serving params (CPU tensors).

    ``template`` is the restoring layout's ReplicaState of tensors or
    ``Spec`` leaves (as ``load_replica_state`` takes it).  The
    checkpoint's policy comes from its manifest; an FSDP or streamed one
    raises (the FSDP slice).
    """
    sharding = ckpt.checkpoint_sharding(path)
    state = ckpt.load_replica_state(path, template, sharding=sharding)
    return replica_mod.consolidate_state(state)
