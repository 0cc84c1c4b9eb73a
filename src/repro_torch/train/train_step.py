"""Data-parallel train step (WAGMA-SGD and the baselines), replicated: on
one device, or one replica a rank.

Counterpart of the replicated branch of ``repro/train/train_step.py``.
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

**The rank realisation.**  Over a rank world (``launch/mesh.py``; the
averager's ``world``) each process holds its own replica as ``(1, ...)``
rows and a ``(1,)`` count, as JAX's ``shard_map`` sees a ``(1, ...)``
block of the ``(P, ...)`` global array, and is handed its own rows of the
batch.  The step is the same code with one row: the rank's gradients, its
guarded update, then ``averager.comm``/``sync`` over the wire
(``core/plan.py``); the metrics are averaged over the ranks by one
``all_reduce``, as the reference's ``pmean`` over dp.

Step variants: the host loop (``launch/train.py`` ``Trainer._step_fn``)
calls ``averager.phase_for_step(t)``/``sync_due(t)`` and runs one of
``averager.n_phases + 1`` cached step functions, as JAX dispatches its
compiled variants.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.core.replica import ReplicaState, map_opt_state


def local_rows(averager) -> int:
    """Replicas this process holds: every one on stacked rows, its own
    over a rank world."""
    return averager.P if averager.world is None else 1


def stacked_init(model, n_replicas: int, generator: torch.Generator):
    """One init, broadcast to ``n_replicas`` rows: (P, ...) leaves."""
    params0 = model.init(generator)
    return tr.tree_map(
        lambda a: a[None].expand((n_replicas,) + tuple(a.shape)).clone(),
        params0)


def init_replica_state(model, optimizer, averager,
                       generator: torch.Generator) -> ReplicaState:
    """The :class:`ReplicaState` the train step operates on: stacked
    params identical in every row, the optimiser state of the stacked tree
    with a ``(P,)`` count (one row and a ``(1,)`` count on a rank)."""
    if averager.sharding.is_sharded:
        raise NotImplementedError("only the replicated policy is ported")
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


def build_train_step(model, optimizer, averager, *, phase: int, sync: bool,
                     microbatch: Optional[int] = None):
    """Returns ``step(state, batch) -> (state, metrics)`` for one variant:
    group averaging at ``phase``, or the global sync.  The loss recomputes
    each superblock in the backward (``remat``), as the JAX step does."""
    n_rep = local_rows(averager)

    def grads_and_metrics(params, batch):
        if not (microbatch and microbatch > 1):
            return value_and_grad(model, params, batch)
        b_local = next(iter(batch.values())).shape[0]
        if b_local % microbatch or b_local < microbatch:
            raise ValueError(
                f"microbatch={microbatch} must divide the per-replica "
                f"batch {b_local}")
        n = b_local // microbatch
        acc, metrics_all = None, []
        for i in range(microbatch):
            g, m = value_and_grad(
                model, params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            acc = (tr.tree_map(lambda a: a.float(), g) if acc is None
                   else tr.tree_map(lambda a, b: a + b.float(), acc, g))
            metrics_all.append(m)
        grads = tr.tree_map(lambda a: a / microbatch, acc)
        metrics = {k: torch.stack([m[k] for m in metrics_all]).mean()
                   for k in metrics_all[0]}
        return grads, metrics

    def update_rows(state, r, grads):
        """Replica r's guarded update from ``grads``, written into its rows
        in place; returns whether the non-finite guard skipped it."""
        params_r = _row(state.params, r)
        opt_r = map_opt_state(state.opt_state, lambda t: _row(t, r),
                              lambda c: c[r])
        new_p, new_o, skipped = guarded_update(optimizer, grads, opt_r,
                                               params_r)
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
        per_replica = []
        if averager.grad_comm:
            # every replica's gradients before any update: (P, ...) rows
            stacked = None
            for r in range(n_rep):
                grads, metrics = grads_and_metrics(_row(state.params, r),
                                                   local(r))
                if stacked is None:
                    stacked = tr.tree_map(
                        lambda g: g.new_empty((n_rep,) + tuple(g.shape)),
                        grads)
                _write(_row(stacked, r), grads)
                per_replica.append(dict(metrics))
                del grads
            grads = (averager.sync(stacked) if sync
                     else averager.comm(stacked, phase))
            del stacked
            for r in range(n_rep):
                skipped = update_rows(state, r, _row(grads, r))
                per_replica[r]["skipped_nonfinite"] = torch.tensor(
                    float(skipped))
            del grads
            params = state.params
        else:
            for r in range(n_rep):
                grads, metrics = grads_and_metrics(_row(state.params, r),
                                                   local(r))
                skipped = update_rows(state, r, grads)
                metrics = dict(metrics)
                metrics["skipped_nonfinite"] = torch.tensor(float(skipped))
                per_replica.append(metrics)
                del grads
            params = (averager.sync(state.params) if sync
                      else averager.comm(state.params, phase))
        if averager.world is None:
            metrics = {k: torch.stack([m[k].cpu() for m in per_replica]
                                      ).mean() for k in per_replica[0]}
        else:
            metrics = mean_over_ranks(averager.world, per_replica[0])
        return ReplicaState(params, state.opt_state, state.step + 1,
                            -1 if sync else phase), metrics

    return step


def mean_over_ranks(world, metrics: dict) -> dict:
    """This rank's float32 metrics averaged over every rank by one
    ``all_reduce`` through the wire."""
    keys = list(metrics)
    vec = torch.stack([metrics[k].to(world.device, torch.float32)
                       for k in keys])[None]
    mean = plan_mod.wire_for(world).pmean_rows(vec)[0].cpu()
    return dict(zip(keys, mean.unbind(0)))
