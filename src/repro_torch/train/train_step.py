"""Data-parallel train step (WAGMA-SGD and the baselines): replicated on
one device or one replica a rank, FSDP-within-pod on one device or one
member a rank, gather-all or layer-streamed.

Counterpart of ``repro/train/train_step.py``.
Per replica: local gradients, a local optimiser step guarded against
non-finite gradients, then the averager's collective over all replicas
(group butterfly, or the global mean every tau steps).  An averager with
``grad_comm`` (Allreduce-SGD, Eager-SGD) averages the gradients instead,
before the update.

**The one-card realisation.**  The :class:`ReplicaState` holds every
replica as a row: params and moments ``(P, ...)``, the optimiser's count
``(P,)``.  Where JAX runs one replica per device inside ``shard_map``, the
step here loops over the rows: each replica's gradients are computed on
its own rows of the global batch (replica r takes rows ``[r*b, (r+1)*b)``).
Under a model-averaging averager (WAGMA, local SGD, the gossip baselines)
replica r's update is written into its rows in place before the next
replica's gradients are taken, so only one replica's gradients and
activations are live.  The finite check and the guarded update are per
replica, as each device does its own in JAX.

A gradient-averaging averager needs every replica's gradients before any
update, so its step takes two passes: the first writes each replica's
gradients into a stacked ``(P, ...)`` tree in the gradients' own dtype,
``averager.comm`` (or ``sync``) averages it through the plan in float32
buckets and casts back, as the JAX ``grad_comm`` branch does; the second
runs each replica's guarded update on its averaged rows.  The finite check
reads the averaged gradients, so one poisoned replica makes every replica
skip.  This holds P gradient copies live beside the float32 buckets: at
transformer_wmt (79,724,544 params) with P = 16, 2.55 GB of bf16
gradients and 5.1 GB of buckets.  Metrics are the mean over
replicas, as ``pmean`` gives them.  The step consumes the state it is
given (its optimiser state is updated in place), as the JAX step donates
its state.

**FSDP within a pod** (``ShardingPolicy.fsdp_within_pod``, DESIGN.md
§10).  The state is the plan's ``(P_eff, n_b)`` shard buffers, a row a pod
(``core/replica.py``).  The step walks the pods: it unpacks the pod's row
once into a tree of views (the JAX step's all-gather), takes each member's
gradients on that tree and its own batch rows, accumulates them into one
set of float32 buffers in member order and scales them by
``1/pod_size`` (``plan.grad_shards``, the reduce-scatter), checks the pod
mean for non-finite values (one member's NaN skips the whole pod, as the
``pmin`` over the shard axis does, and only that pod), and updates the
pod's row in place.  Microbatches accumulate the per-microbatch pod means
into a second float32 set, then divide, as the reference's scan does.  At
most one pod's tree, one member's gradients and its float32 accumulator
are live; the butterfly then averages the buffers pod to pod.

**Layer-streamed FSDP** (``streamed=True``, DESIGN.md §11).  The plan is
compiled over the model's layered tree and its shard layout is layer-
aware; ``streaming.streamed_loss_and_grad_shards`` takes the place of the
pod's unpack, members' gradients and ``grad_shards``: it walks the pod's
members span by span and packs each group's gradients into the pod's
float32 buffers as soon as its VJP completes, so no member's whole
gradient tree exists.  The buffers equal the gather-all path's bit for
bit; microbatches, the guard and the update are the gather-all branch's.

**The rank realisation.**  Over a rank world (``launch/mesh.py``; the
averager's ``world``) each process holds its own replica as ``(1, ...)``
rows and a ``(1,)`` count, as JAX's ``shard_map`` sees a ``(1, ...)``
block of the ``(P, ...)`` global array, and is handed its own rows of the
batch.  The step is the same code with one row: the rank's gradients, its
guarded update, then ``averager.comm``/``sync`` over the wire
(``core/plan.py``); the metrics are averaged over the ranks by one
``all_reduce``, as the reference's ``pmean`` over dp.

**FSDP over ranks** (gather-all or layer-streamed).  Each rank is one
member of its pod and holds its column slices of the pod's shard buffers,
``(1, n_b / pod_size)``, and a ``(1,)`` count (``core/replica.py``).  The
unit is this rank alone: ``plan.unshard_tree`` all-gathers its pod's tree
over the pod's ranks, the gradients are taken on its own batch rows,
``plan.grad_shards`` reduce-scatters them (per microbatch, accumulated as
on one card), and the guarded update writes its slices.  Streamed, the
engine walks this member's batch alone, posting each group's all-gathers
before the previous span computes and its reduce-scatters as soon as its
VJP ends (``core/streaming.py``), once a microbatch.  The non-finite
flag is the MIN over the pod's ranks (:func:`pod_all_finite`, the
reference's ``pmin`` over the shard axis): one member's NaN lands in one
slice only, and the whole pod must skip.  The metrics are the mean over
every dp rank.

**The model axis.**  Over a rank world with ``model`` ranks a replica
(``launch/mesh.py``), each rank holds its replica's slices by
``models/common.placement`` (``stacked_init`` cuts them from the one
seeded init a model-1 run draws) and the model's entry points compute the
rank's part (``models/transformer.py``).  The model ranks of a replica
are handed the same batch rows (by dp rank).  The gradients of the leaves
held whole are whole on every rank (``copy_to_model`` sums those whose use
sees only the rank's heads), so those leaves stay bit-identical over the
model group.  The non-finite guard takes the MIN of its flag over the
model group, so one bad slice skips the whole replica.  The plan is
compiled over the rank's own leaves and averages them over its dp group:
the combine is elementwise, so the gathered average is the whole rows'
average.  Under FSDP (gather-all or layer-streamed) the sharded plan is
compiled over the rank's slice tree too, so each rank holds its shard
slice of its model coordinate's buckets, and the guard is the MIN over
the model group and then over the pod at its model coordinate: every
one of a pod's ``pod_size x model`` ranks agrees, as the reference's
global ``isfinite`` under GSPMD does.

Step variants: the host loop (``launch/train.py`` ``Trainer._step_fn``)
calls ``averager.phase_for_step(t)``/``sync_due(t)`` and runs one of
``averager.n_phases + 1`` cached step functions, as JAX dispatches its
compiled variants.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import bucketing, streaming
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.core.replica import (ReplicaState, map_opt_state,
                                      pod_members)
from repro_torch.models import common as cm


def local_rows(averager) -> int:
    """Replicas this process holds: every one on stacked rows, its own
    over a rank world."""
    return averager.P if averager.world is None else 1


def stacked_init(model, n_replicas: int, generator: torch.Generator):
    """One init, broadcast to ``n_replicas`` rows: (P, ...) leaves; with a
    model world, this rank's slices of it (``model.init``'s)."""
    params0 = model.init(generator)
    return tr.tree_map(
        lambda a: a[None].expand((n_replicas,) + tuple(a.shape)).clone(),
        params0)


def layered_of(model):
    """The model's per-layer decomposition, which streamed FSDP needs."""
    if model.layered is None:
        raise ValueError(
            f"--sharding fsdp --streamed needs a per-layer apply "
            f"decomposition, but the {model.cfg.family!r} family does not "
            "expose one (models/registry.ModelAPI.layered)")
    return model.layered


def _param_specs(model, whole: bool = False):
    """One replica's params as Specs (the family's ``param_specs``): with
    a model world this rank's slices of them unless ``whole``; layered
    under the streamed policy."""
    from repro_torch.models.convert import PARAM_SPECS
    specs = PARAM_SPECS[model.cfg.family](model.cfg)
    mw = model.model_world
    if mw is not None and not whole:
        specs = cm.take_slices(specs, cm.placement(model.cfg, specs,
                                                   mw.size), mw)
    return specs


def plan_of(model, averager):
    """The averager's compiled plan for the model's params tree (one
    replica's structure, from the family's ``param_specs``; with a model
    world this rank's slice tree), as the JAX step's ``_plan_of``: a
    sharded plan is compiled from the full tree, never from a state's
    shard buffers; a streamed one from the layered tree (``layered.split``
    of the specs)."""
    specs = _param_specs(model)
    if averager.sharding.is_sharded and averager.sharding.streamed:
        specs = layered_of(model).split(specs)
    return averager.plan_for(tr.tree_map(
        lambda s: tr.Spec((1,) + tuple(s.shape), s.dtype), specs))


def whole_plan_of(model, averager):
    """The sharded plan of the model's whole tree in one process: the
    layout of a model-1 run's state, which a model world's gathered state
    and checkpoint keep (:func:`plan_of` itself without a model world)."""
    plan = plan_of(model, averager)
    if model.model_world is None:
        return plan
    specs = _param_specs(model, whole=True)
    if plan.sharding.streamed:
        specs = layered_of(model).split(specs)
    return plan_mod.compile_plan(plan.topology, specs, plan.cfg,
                                 plan.sharding)


def model_dims(model, plan) -> Optional[object]:
    """The placement of one replica's whole tree over the model ranks
    (``common.placement`` of ``whole_plan_of``'s storage tree), which
    ``replica.model_rank_slices`` and ``join_model_slices`` read; ``None``
    without a model world."""
    mw = model.model_world
    return None if mw is None else cm.placement(model.cfg,
                                                plan.storage_struct, mw.size)


def init_replica_state(model, optimizer, averager,
                       generator: torch.Generator) -> ReplicaState:
    """The :class:`ReplicaState` the train step operates on: stacked
    params identical in every row, the optimiser state of the stacked tree
    with a ``(P,)`` count (one row and a ``(1,)`` count on a rank).  Under
    ``fsdp_within_pod``: one init packed into the plan's shard layout and
    broadcast to ``(P_eff, n_b)`` buffers, float32 moments of the same
    shapes and a ``(P_eff,)`` count; over ranks this rank's ``(1, n_b /
    pod_size)`` slices of them (of its model coordinate's buffers, packed
    from the slices ``model.init`` returns) and a ``(1,)`` count."""
    if averager.sharding.is_sharded and averager.world is not None:
        plan = plan_of(model, averager)
        params0 = model.init(generator)
        if averager.sharding.streamed:
            params0 = model.layered.split(params0)
        params = plan.shard_tree(tr.tree_map(lambda a: a[None], params0))
        del params0
        rows = 1
    elif averager.sharding.is_sharded:
        params0 = model.init(generator)
        plan = plan_of(model, averager)
        if averager.sharding.streamed:
            params0 = model.layered.split(params0)
        packed = bucketing.pack(params0, plan.shard_layout)
        del params0
        rows = plan.P_eff
        params = tuple(b[None].expand((rows,) + tuple(b.shape)).clone()
                       for b in packed)
        del packed
    else:
        rows = local_rows(averager)
        params = stacked_init(model, rows, generator)
    opt = map_opt_state(optimizer.init(params), lambda t: t,
                        lambda c: torch.zeros(rows, dtype=torch.int32))
    return ReplicaState(params, opt)


def tree_all_finite(tree) -> torch.Tensor:
    """Bool tensor: every leaf of ``tree`` is NaN/Inf-free."""
    leaves = tr.tree_leaves(tree)
    if not leaves:
        return torch.tensor(True)
    return torch.stack([torch.isfinite(l).all() for l in leaves]).all()


def replica_all_finite(model, grads) -> torch.Tensor:
    """:func:`tree_all_finite` of a replica's gradients: with a model
    world, the MIN of every model rank's flag."""
    finite = tree_all_finite(grads)
    mw = model.model_world
    if mw is None:
        return finite
    flag = finite.to(device=tr.tree_leaves(grads)[0].device,
                     dtype=torch.int32).reshape(1)
    return cm.model_all_reduce(flag, mw, op=dist.ReduceOp.MIN)[0].bool()


def pod_all_finite(plan, finite: torch.Tensor) -> torch.Tensor:
    """A rank's non-finite flag over its pod under FSDP over ranks: the MIN
    over the pod's members (the reference's ``pmin`` over the shard axis),
    so that a NaN in one member's slice skips every member's update; the
    flag itself elsewhere."""
    if plan is None or not plan.sharding.is_sharded or plan.world is None:
        return finite
    return plan.shard_wire.shard_all_finite(finite,
                                            plan.sharding.shard_axis)


def guarded_update(optimizer, grads, opt_state, params, *, finite=None):
    """Optimiser update with the non-finite gradient guard (DESIGN.md §13).

    When ``grads`` hold a NaN/Inf the update is skipped: params and
    optimiser state come back as they were, bit-exact, so a diverging
    replica contributes its last good weights to the average.  Returns
    ``(new_params, new_opt_state, skipped)``.
    """
    if finite is None:
        finite = tree_all_finite(grads)
    if not bool(finite):
        return params, opt_state, True
    new_params, new_opt = optimizer.update(grads, opt_state, params)
    return new_params, new_opt, False


def _row(tree, r: int):
    """Replica r's rows: views into the stacked leaves."""
    return tr.tree_map(lambda a: a[r], tree)


def _write(dst_tree, src_tree):
    tr.tree_map(lambda dst, src: dst.copy_(src), dst_tree, src_tree)


def value_and_grad(model, params, batch):
    """One replica's ``(grads, metrics)`` of ``model.loss`` with remat."""
    leaves, treedef = tr.tree_flatten(params)
    leaves = [l.detach().requires_grad_(True) for l in leaves]
    loss, metrics = model.loss(tr.tree_unflatten(treedef, leaves), batch,
                               remat=True)
    grads = torch.autograd.grad(loss, leaves)
    return (tr.tree_unflatten(treedef, list(grads)),
            {k: v.detach().float() for k, v in metrics.items()})


def _microbatches(batch, microbatch: Optional[int]):
    """The batch's ``microbatch`` equal slices of rows (itself alone when
    ``microbatch`` is unset or 1)."""
    if not (microbatch and microbatch > 1):
        return [batch]
    b_local = next(iter(batch.values())).shape[0]
    if b_local % microbatch or b_local < microbatch:
        raise ValueError(
            f"microbatch={microbatch} must divide the per-replica "
            f"batch {b_local}")
    n = b_local // microbatch
    return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            for i in range(microbatch)]


def _mean_metrics(metrics_all):
    if len(metrics_all) == 1:
        return metrics_all[0]
    return {k: torch.stack([m[k] for m in metrics_all]).mean()
            for k in metrics_all[0]}


def build_train_step(model, optimizer, averager, *, phase: int, sync: bool,
                     microbatch: Optional[int] = None):
    """Returns ``step(state, batch) -> (state, metrics)`` for one variant:
    group averaging at ``phase``, or the global sync.  The loss recomputes
    each superblock in the backward (``remat``), as the JAX step does."""
    n_rep = local_rows(averager)
    sharded = averager.sharding.is_sharded
    streamed = sharded and averager.sharding.streamed
    layered = layered_of(model) if streamed else None

    def grads_and_metrics(params, batch):
        mbs = _microbatches(batch, microbatch)
        if len(mbs) == 1:
            return value_and_grad(model, params, batch)
        acc, metrics_all = None, []
        for mb in mbs:
            g, m = value_and_grad(model, params, mb)
            acc = (tr.tree_map(lambda a: a.float(), g) if acc is None
                   else tr.tree_map(lambda a, b: a + b.float(), acc, g))
            metrics_all.append(m)
        grads = tr.tree_map(lambda a: a / microbatch, acc)
        return grads, _mean_metrics(metrics_all)

    def pod_grads_and_metrics(plan, shards, pod, members, local):
        """Pod ``pod``'s float32 pod-mean grad buffers from its members'
        gradients on the pod's unpacked tree (streamed: span by span), and
        each member's metrics."""
        per_mb = {r: _microbatches(local(r), microbatch) for r in members}
        n_mb = len(per_mb[members[0]])
        metrics_all = {r: [] for r in members}
        tree = None if streamed else plan.unshard_tree(shards, pod)

        def member_grads(i):
            for r in members:
                g, m = value_and_grad(model, tree, per_mb[r][i])
                metrics_all[r].append(m)
                yield g
                del g

        def pod_mean(i):
            """Microbatch i's float32 pod-mean grad buffers."""
            if not streamed:
                return plan.grad_shards(member_grads(i))
            _, ms, gs = streaming.streamed_loss_and_grad_shards(
                plan, layered, shards, [per_mb[r][i] for r in members],
                pod=pod, overlap=plan.cfg.overlap)
            for r, m in zip(members, ms):
                metrics_all[r].append(m)
            return gs

        if n_mb == 1:
            acc = pod_mean(0)
        else:
            # the reference's scan: zeros + each microbatch's pod mean
            acc = None
            for i in range(n_mb):
                gs = pod_mean(i)
                if acc is None:
                    acc = tuple(torch.zeros_like(g) for g in gs)
                for a, g in zip(acc, gs):
                    a.add_(g)
                del gs
            acc = tuple(a.div_(n_mb) for a in acc)
        return acc, {r: _mean_metrics(ms) for r, ms in metrics_all.items()}

    def update_rows(state, r, grads, plan=None):
        """Row r's guarded update from ``grads`` (a replica's, or a pod's
        under FSDP; over ranks a member's slices, the flag over its pod),
        written into its rows in place; returns whether the non-finite
        guard skipped it."""
        params_r = _row(state.params, r)
        opt_r = map_opt_state(state.opt_state, lambda t: _row(t, r),
                              lambda c: c[r])
        finite = replica_all_finite(model, grads)
        new_p, new_o, skipped = guarded_update(
            optimizer, grads, opt_r, params_r,
            finite=pod_all_finite(plan, finite))
        if not skipped:
            _write(params_r, new_p)
            for f in opt_r._fields:
                if f == "count":
                    state.opt_state.count[r] = new_o.count
                else:
                    _write(getattr(opt_r, f), getattr(new_o, f))
        return skipped

    def step(state: ReplicaState, batch):
        rows = next(iter(batch.values())).shape[0]
        if rows % n_rep:
            raise ValueError(f"global batch {rows} does not split over "
                             f"{n_rep} replicas")
        b = rows // n_rep
        local = lambda r: {k: v[r * b:(r + 1) * b] for k, v in batch.items()}
        # a unit is a row of the state: a replica, or under FSDP a pod and
        # its members (the dp ranks whose batch rows it trains on); over
        # ranks this rank, one member of its pod
        plan = None
        if sharded and averager.world is not None:
            plan = plan_of(model, averager)
            units = [(0,)]
            pod = averager.world.pod_of(plan.sharding.shard_axis)

            def unit_grads(u):
                return pod_grads_and_metrics(plan, state.params, pod,
                                             units[u], local)
        elif sharded:
            plan = plan_of(model, averager)
            units = [pod_members(plan, e) for e in range(plan.P_eff)]

            def unit_grads(u):
                return pod_grads_and_metrics(plan, state.params, u, units[u],
                                             local)
        else:
            units = [(r,) for r in range(n_rep)]

            def unit_grads(u):
                grads, metrics = grads_and_metrics(_row(state.params, u),
                                                   local(u))
                return grads, {u: metrics}

        metrics_of = {}

        def note_skip(u, skipped):
            for r in units[u]:
                metrics_of[r] = dict(metrics_of[r])
                metrics_of[r]["skipped_nonfinite"] = torch.tensor(
                    float(skipped))

        if averager.grad_comm:
            # every unit's gradients before any update: stacked rows
            stacked = None
            for u in range(len(units)):
                grads, ms = unit_grads(u)
                metrics_of.update(ms)
                if stacked is None:
                    stacked = tr.tree_map(
                        lambda g: g.new_empty((len(units),)
                                              + tuple(g.shape)), grads)
                _write(_row(stacked, u), grads)
                del grads
            grads = (averager.sync(stacked) if sync
                     else averager.comm(stacked, phase))
            del stacked
            for u in range(len(units)):
                note_skip(u, update_rows(state, u, _row(grads, u), plan))
            del grads
            params = state.params
        else:
            for u in range(len(units)):
                grads, ms = unit_grads(u)
                metrics_of.update(ms)
                note_skip(u, update_rows(state, u, grads, plan))
                del grads
            params = (averager.sync(state.params) if sync
                      else averager.comm(state.params, phase))
        per_replica = [metrics_of[r] for r in sorted(metrics_of)]
        if averager.world is None:
            metrics = {k: torch.stack([m[k].cpu() for m in per_replica]
                                      ).mean() for k in per_replica[0]}
        else:
            metrics = mean_over_ranks(averager.world, per_replica[0])
        return ReplicaState(params, state.opt_state, state.step + 1,
                            -1 if sync else phase), metrics

    return step


def mean_over_ranks(world, metrics: dict) -> dict:
    """This rank's float32 metrics averaged over every dp rank by one
    sum through the wire (the model ranks of a replica hold the
    same metrics)."""
    keys = list(metrics)
    vec = torch.stack([metrics[k].to(world.device, torch.float32)
                       for k in keys])[None]
    mean = plan_mod.wire_for(world).sync_rows_(vec)[0].cpu()
    return dict(zip(keys, mean.unbind(0)))
