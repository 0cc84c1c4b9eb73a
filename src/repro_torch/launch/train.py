"""Training driver: the data-parallel SGD loop (WAGMA-SGD or a baseline
averager), replicated on one device or one replica a rank, or FSDP within
a pod on one device or one member a rank.

Counterpart of ``repro/launch/train.py``.  Builds the model, optimiser and
averager; keeps the cache of step variants (one per butterfly phase offset
+ the tau-sync step); streams synthetic data; logs metrics; checkpoints.
The ``pod_axis x data_axis`` replicas (dp axes minor to major, as
``dp_axis_layout`` names them) are the rows of the stacked state on
``device``, or, over a rank world (``launch/mesh.py``), one replica a
rank, as JAX lays them over a mesh's ``pod`` and ``data`` axes.

    python -m repro_torch.launch.train --arch tinyllama-1.1b --data-axis 8 \\
        --group-size 4 --tau 5 --steps 12
    python -m torch.distributed.run --standalone --nproc-per-node 4 \\
        -m repro_torch.launch.train --arch tinyllama-1.1b --data-axis 2 \\
        --pod-axis 2 --pod-dcn --ckpt-dir ckpt
    python -m repro_torch.launch.train --arch tinyllama-1.1b --data-axis 2 \\
        --pod-axis 4 --pod-dcn --sharding fsdp --group-size 2 --tau 5
    python -m torch.distributed.run --standalone --nproc-per-node 8 \\
        -m repro_torch.launch.train --arch tinyllama-1.1b --data-axis 2 \\
        --pod-axis 4 --pod-dcn --sharding fsdp --group-size 2 --tau 5
    python -m torch.distributed.run --standalone --nproc-per-node 8 \\
        -m repro_torch.launch.train --arch tinyllama-1.1b --data-axis 2 \\
        --pod-axis 4 --pod-dcn --sharding fsdp --streamed --group-size 2
    python -m torch.distributed.run --standalone --nproc-per-node 8 \\
        -m repro_torch.launch.train --arch tinyllama-1.1b --data-axis 2 \\
        --pod-axis 2 --model-axis 2 --pod-dcn --sharding fsdp --streamed

runs on the CUDA card; ``REPRO_TORCH_DEVICE=cpu`` asks for the CPU (add
``--smoke`` there).  Under torchrun (``WORLD_SIZE`` > 1) each rank trains
its own replica over the backend ``REPRO_TORCH_BACKEND`` names (default
nccl on the card, gloo on the CPU; ``gloo`` lets ranks share one card).
``--model-axis M`` (every family) splits each replica's model over M
ranks, model minor (``launch/mesh.py``):
torchrun starts ``data x pod x M`` ranks.  ``--sharding fsdp`` makes the
members of each pod (the replicas that differ on the minor dp axis) one
logical worker sharing one set of shard buffers (``core/replica.py``):
on one device the rows of one state, under torchrun one member a rank,
each holding its column slice of its pod's buffers (the gather-all
engine: an all-gather, a reduce-scatter and the pod-to-pod butterfly
over the ranks); a checkpoint gathers the slices on rank 0 and is the
one-device run's, byte for byte.  ``--streamed`` adds the layer-streamed
engine (``core/streaming.py``), the dense family's only, on one device or
under torchrun (each span's all-gathers posted before the previous span
computes, its reduce-scatters as soon as its VJP ends).  With
``--model-axis`` > 1 as well, each member rank holds its shard slice of
its model coordinate's buckets (the sharded plan compiled over its slice
tree); the checkpoint is still the one-device run's layout, every model
coordinate's slices joined.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_replica_state
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.baselines import AVERAGERS, make_averager
from repro_torch.core.plan import Topology
from repro_torch.core.replica import (REPLICATED, ReplicaState,
                                      ShardingPolicy, join_model_slices,
                                      map_opt_state, model_rank_slices,
                                      pod_members)
from repro_torch.core import tree as tr
from repro_torch.data import make_batch_fn
from repro_torch.launch import mesh
from repro_torch.models import common as cm
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, sgd
from repro_torch.serve.handoff import serving_weights_from_state
from repro_torch.train import build_train_step, init_replica_state
from repro_torch.train.train_step import model_dims, plan_of, whole_plan_of

# a moe model's metrics beside the loss, logged with it
ROUTER_METRICS = ("load_balance", "router_z", "moe_dropped")


def resolve_sharding(sharding, dp_names, streamed: bool = False
                     ) -> ShardingPolicy:
    """CLI/ctor spelling -> ShardingPolicy.

    ``None``/``"replicated"`` -> replicated; ``"fsdp"`` shards over the
    minor (intra-pod) dp axis ``dp_names[0]``; a ready ShardingPolicy
    passes through.  ``streamed=True`` (or the ``"fsdp_streamed"``
    spelling) selects the layer-streamed state layout (DESIGN.md §11).
    """
    if isinstance(sharding, ShardingPolicy):
        if streamed and not sharding.streamed:
            return dataclasses.replace(sharding, streamed=True)
        return sharding
    if sharding == "fsdp_streamed":
        sharding, streamed = "fsdp", True
    if sharding is None or sharding == "replicated":
        if streamed:
            raise ValueError("--streamed requires --sharding fsdp")
        return REPLICATED
    if sharding == "fsdp":
        return ShardingPolicy.fsdp_within_pod(dp_names[0], streamed=streamed)
    raise ValueError(f"unknown sharding {sharding!r}; options: "
                     f"replicated | fsdp | fsdp_streamed | "
                     f"ShardingPolicy(...)")


class Trainer:
    def __init__(self, cfg, data_axis: int, *, pod_axis=None, world=None,
                 device=None, averager="wagma", group_size=None, tau=10,
                 optimizer="sgd", learning_rate=0.1, momentum=0.9,
                 seq_len=512, global_batch=None, seed=0, microbatch=None,
                 imbalanced=False, topology=None, sharding=None,
                 streamed=False, init_state=None, fault_injector=None):
        self.cfg = cfg
        names, sizes = mesh.dp_axes(data_axis, pod_axis)
        self.world = world
        if world is not None:
            if (world.axis_names, world.axis_sizes) != (names, sizes):
                raise ValueError(f"rank world axes {world.axis_names}/"
                                 f"{world.axis_sizes} do not match the dp "
                                 f"axes {names}/{sizes}")
            if device is not None and torch.device(device) != world.device:
                raise ValueError(f"device {device} given to a rank on "
                                 f"{world.device}")
            device = world.device
        self.device = torch.device(device or "cuda")
        self.model = build_model(cfg, device=self.device, model_world=(
            world.model_world if world is not None else None))
        self.n_dp = int(np.prod(sizes))
        self.sharding = resolve_sharding(sharding, names, streamed=streamed)
        kw = {}
        if averager == "wagma":
            kw = {"group_size": group_size, "tau": tau}
        elif averager == "local_sgd":
            kw = {"sync_period": tau}
        if topology is not None:
            kw["topology"] = topology
        kw["sharding"] = self.sharding
        kw["world"] = world
        self.averager = make_averager(averager, names, sizes, **kw)
        if optimizer == "sgd":
            self.opt = sgd(learning_rate, momentum=momentum)
        else:
            self.opt = adamw(learning_rate)
        self.shape = InputShape("custom", seq_len,
                                global_batch or 8 * self.n_dp, "train")
        self.batch_fn = make_batch_fn(cfg, self.shape, seed=seed,
                                      imbalanced=imbalanced)
        self.microbatch = microbatch
        self._steps = {}
        if init_state is not None:
            # warm start: seat a ReplicaState (e.g. converted from a JAX
            # run) with this run's replica count
            self.state = self._put_state(init_state)
        else:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.state = init_replica_state(self.model, self.opt,
                                            self.averager, gen)
        # a core.faults.FaultInjector: its wall-clock faults fire at the
        # top of step_once
        self.fault_injector = fault_injector
        # replica-steps whose optimiser update the non-finite guard skipped
        self.skipped_nonfinite = 0.0
        self.last_metrics = {}

    def _put_state(self, state: ReplicaState) -> ReplicaState:
        """The state's params and moments on this run's device (the count
        stays on the host), checked against the replica count (the pod
        count under FSDP).  A rank keeps its own row of the ``(P, ...)``
        state, and with a model world its slices of it; an FSDP member
        its column slices of its pod's row (with a model world, of its
        model coordinate's buffers), from a model-1 run's state."""
        rows = tr.tree_leaves(state.params)[0].shape[0]
        if rows != self.averager.P_eff:
            raise ValueError(f"state has {rows} replica rows; this run has "
                             f"{self.averager.P_eff}")
        if self.sharding.is_sharded and self.world is not None:
            # a member's column slices of its pod's row, its pod's count
            plan, whole, world = self.plan(), self.whole_plan(), self.world
            pod = world.pod_of(self.sharding.shard_axis)
            dims = model_dims(self.model, whole)

            def put(t, dtype=None):
                return tuple(a.to(self.device) for a in model_rank_slices(
                    t, whole, plan, world, dims, dtype=dtype))
            return ReplicaState(
                put(state.params),
                map_opt_state(state.opt_state,
                              lambda t: put(t, torch.float32),
                              lambda c: c[pod:pod + 1].cpu()),
                state.step, state.phase)
        r = self._rows()
        mw = self.model.model_world

        def put(t):
            t = tr.tree_map(lambda a: a[r], t)
            if mw is not None:
                t = cm.take_slices(t, cm.placement(self.cfg, t, mw.size), mw)
            return tr.tree_map(lambda a: a.to(self.device), t)

        return ReplicaState(put(state.params),
                            map_opt_state(state.opt_state, put,
                                          lambda c: c[r].cpu()),
                            state.step, state.phase)

    def _rows(self) -> slice:
        """The rows of the global state and batch this process holds."""
        if self.world is None:
            return slice(None)
        return slice(self.world.rank, self.world.rank + 1)

    def plan(self):
        """The compiled AveragingPlan the train step executes (under FSDP
        the sharded plan, compiled from the model's full tree, with a
        model world from this rank's slice tree; streamed, from its
        layered tree)."""
        if self.sharding.is_sharded:
            return plan_of(self.model, self.averager)
        return self.averager.plan_for(self.state.params)

    def whole_plan(self):
        """Under FSDP the plan whose layout the gathered state, the
        checkpoint and a warm start hold: the model-1 run's
        (:meth:`plan`'s own without a model world)."""
        return whole_plan_of(self.model, self.averager)

    def _step_fn(self, t: int):
        sync = self.averager.sync_due(t)
        phase = self.averager.phase_for_step(t)
        key = ("sync",) if sync else ("group", phase)
        if key not in self._steps:
            self._steps[key] = build_train_step(
                self.model, self.opt, self.averager, phase=phase, sync=sync,
                microbatch=self.microbatch)
        return self._steps[key]

    def _put_batch(self, t: int):
        """The global batch of step ``t`` on the device; replica r takes
        rows ``[r*b, (r+1)*b)`` (a rank is handed its own)."""
        nb = self.batch_fn(t, 0, self.shape.global_batch)
        if self.world is not None:
            b = self.shape.global_batch // self.n_dp
            r = self.world.rank
            nb = {k: v[r * b:(r + 1) * b] for k, v in nb.items()}
        return {k: torch.as_tensor(
                    v, dtype=(torch.int64 if np.issubdtype(v.dtype, np.integer)
                              else torch.float32)).to(self.device)
                for k, v in nb.items()}

    def step_once(self, t: int) -> float:
        """Run global step ``t`` (data, variant dispatch, update); returns
        the loss (mean over replicas)."""
        if self.fault_injector is not None:
            self.fault_injector.before_step(t)
        batch = self._put_batch(t)
        step = self._step_fn(t)
        self.state, metrics = step(self.state, batch)
        self.last_metrics = {k: float(v) for k, v in metrics.items()}
        self.skipped_nonfinite += \
            self.last_metrics.get("skipped_nonfinite", 0.0) * self.n_dp
        return self.last_metrics["loss"]

    def gathered_state(self):
        """The ``(P, ...)`` ReplicaState on the host: every rank's row
        gathered on rank 0 (``None`` on the other ranks); with a model
        world, every rank's slices joined into whole leaves, so the state
        is the one a model-1 run would hold; under FSDP (gather-all or
        streamed), every member's column slices joined into its pod's row,
        the one-process run's ``(P_eff, n_b)`` state in its plan's flat or
        grouped layout (with a model world, every model coordinate's
        buffers joined into the model-1 run's)."""
        st = self.state
        moments = None
        if self.world is None:
            get = get_count = lambda t: tr.tree_map(lambda a: a.cpu(), t)
        elif self.sharding.is_sharded:
            # every member's slices joined into each pod's row; a pod's
            # count from its first member (its members skip together)
            plan, whole = self.plan(), self.whole_plan()
            firsts = [pod_members(plan, e)[0] for e in range(plan.P_eff)]
            dims = model_dims(self.model, whole)

            def get(t, dtype=None):
                rows = mesh.gather_world_rows(self.world, t)
                return None if rows is None else join_model_slices(
                    rows, whole, plan, self.world.model, dims, dtype=dtype)

            def get_count(c):
                rows = mesh.gather_rows(self.world, c)
                return None if rows is None else rows[firsts]

            moments = lambda t: get(t, torch.float32)
        else:
            get = get_count = lambda t: mesh.gather_model_slices(
                self.world, t, cm.placement(self.cfg, t, self.world.model))
        params = get(st.params)
        opt = map_opt_state(st.opt_state, moments or get, get_count)
        if self.world is not None and self.world.torch_rank != 0:
            return None
        return ReplicaState(params, opt, st.step, st.phase)

    def save_checkpoint(self, path: str):
        """Write the whole ReplicaState (rank 0 gathers the rows and
        writes; every rank waits for it).  Returns the state written
        (``None`` on the other ranks)."""
        state = self.gathered_state()
        if state is not None:
            save_replica_state(path, state, sharding=self.sharding,
                               metadata={"arch": self.cfg.name})
        if self.world is not None:
            torch.distributed.barrier()
        return state

    def consolidated(self):
        """The consensus params tree (the replicas' mean; under FSDP the
        pods' mean, unpacked through the plan's shard layout, a streamed
        state's merged back to the canonical tree) a server
        loads: on this run's device in one process; under torchrun rank 0
        consolidates the gathered state on the host and the other ranks
        get ``None``."""
        if self.world is None:
            plan = self.plan() if self.sharding.is_sharded else None
            return serving_weights_from_state(self.state, plan=plan,
                                              model=self.model)
        state = self.gathered_state()
        if state is None:
            return None
        return serving_weights_from_state(
            state,
            plan=self.whole_plan() if self.sharding.is_sharded else None,
            model=self.model)

    def run(self, steps: int, log_every: int = 10, ckpt_dir=None,
            ckpt_every: int = 0):
        history = []
        t0 = time.time()
        log = self.world is None or self.world.torch_rank == 0
        for t in range(steps):
            loss = self.step_once(t)
            history.append(loss)
            if log and log_every and (t % log_every == 0 or t == steps - 1):
                dt = time.time() - t0
                tput = self.shape.global_batch * self.shape.seq_len \
                    * (t + 1) / max(dt, 1e-9)
                skip = (f" skipped_nonfinite {self.skipped_nonfinite:.0f}"
                        if self.skipped_nonfinite else "")
                aux = "".join(f" {k} {self.last_metrics[k]:.4f}"
                              for k in ROUTER_METRICS
                              if k in self.last_metrics)
                print(f"step {t:5d} loss {loss:.4f}{aux} "
                      f"({tput:,.0f} tok/s wall){skip}", flush=True)
            if ckpt_dir and ckpt_every and (t + 1) % ckpt_every == 0:
                self.save_checkpoint(ckpt_dir)
        return history


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--averager", default="wagma", choices=AVERAGERS)
    ap.add_argument("--group-size", type=int, default=None)
    ap.add_argument("--tau", type=int, default=10)
    ap.add_argument("--optimizer", default="sgd")
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=None)
    ap.add_argument("--data-axis", type=int, default=None,
                    help="replicas on the data axis (ranks under torchrun, "
                         "else rows of the stacked state)")
    ap.add_argument("--model-axis", type=int, default=None,
                    help="model ranks a replica (every family, under "
                         "torchrun)")
    ap.add_argument("--pod-axis", type=int, default=None,
                    help="with --data-axis: lay the replicas over (pod, "
                         "data)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--pod-dcn", action="store_true",
                    help="hierarchical topology: the pod axis rides DCN "
                         "constants and budget, data rides ICI")
    ap.add_argument("--sharding", default="replicated",
                    choices=["replicated", "fsdp"])
    ap.add_argument("--streamed", action="store_true",
                    help="with --sharding fsdp: the layer-streamed engine")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--imbalanced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args()

    n_model = args.model_axis or 1
    cfg = get_config(args.arch, smoke=args.smoke)
    ranks = int(os.environ.get("WORLD_SIZE", "1"))
    if n_model > 1 and ranks == 1:
        raise SystemExit(
            f"--model-axis {n_model} splits each replica over model ranks: "
            f"run under torchrun with WORLD_SIZE = data x pod x model "
            f"({args.data_axis or '?'} x {args.pod_axis or 1} x {n_model})")
    if args.multi_pod:
        raise NotImplementedError(
            "--multi-pod is the reference's production mesh of 2 x 16 x 16 "
            "TPU chips; give --data-axis and --pod-axis")
    if not args.data_axis:
        raise SystemExit("give --data-axis: the number of replicas")
    fsdp = args.sharding == "fsdp"

    device = os.environ.get("REPRO_TORCH_DEVICE", "cuda")
    world = None
    if ranks > 1:
        world = mesh.init_rank_world(
            args.data_axis, args.pod_axis, model=n_model, device_type=device,
            backend=os.environ.get("REPRO_TORCH_BACKEND"),
            shard_axis=(resolve_sharding(args.sharding, mesh.dp_axes(
                args.data_axis, args.pod_axis)[0]).shard_axis
                if fsdp else None))
    topology = None
    if args.pod_dcn:
        topology = Topology.hierarchical(
            *mesh.dp_axes(args.data_axis, args.pod_axis), dcn_axes=("pod",))
    try:
        tr_ = Trainer(cfg, args.data_axis, pod_axis=args.pod_axis,
                      world=world, device=None if world else device,
                      averager=args.averager, group_size=args.group_size,
                      tau=args.tau, optimizer=args.optimizer,
                      learning_rate=args.lr, seq_len=args.seq_len,
                      global_batch=args.global_batch,
                      microbatch=args.microbatch,
                      imbalanced=args.imbalanced, topology=topology,
                      sharding=args.sharding, streamed=args.streamed)
        hist = tr_.run(args.steps, ckpt_dir=args.ckpt_dir,
                       ckpt_every=50 if args.ckpt_dir else 0)
        if world is None or world.torch_rank == 0:
            print(f"final loss {hist[-1]:.4f} (start {hist[0]:.4f})")
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    main()
