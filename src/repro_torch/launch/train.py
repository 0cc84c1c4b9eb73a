"""Training driver: the replicated data-parallel SGD loop (WAGMA-SGD or a
baseline averager) on one device.

Counterpart of ``repro/launch/train.py``.  Builds the model, optimiser and
averager; keeps the cache of step variants (one per butterfly phase offset
+ the tau-sync step); streams synthetic data; logs metrics.  The
``data_axis`` replicas are the rows of the stacked state on ``device``
(where JAX spreads them over a mesh's ``data`` axis).

    python -m repro_torch.launch.train --arch tinyllama-1.1b --data-axis 8 \\
        --group-size 4 --tau 5 --steps 12
    python -m repro_torch.launch.train --arch transformer-wmt \\
        --averager allreduce --data-axis 16

runs on the CUDA card; ``REPRO_TORCH_DEVICE=cpu`` asks for the CPU (add
``--smoke`` there).  Flags of the JAX driver whose feature is not ported
yet raise, naming their slice (ROADMAP.md).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.core.baselines import AVERAGERS, make_averager
from repro_torch.core.replica import (FSDP_SLICE, REPLICATED, ReplicaState,
                                      ShardingPolicy, map_opt_state)
from repro_torch.core import tree as tr
from repro_torch.data import make_batch_fn
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, sgd
from repro_torch.train import build_train_step, init_replica_state

# a moe model's metrics beside the loss, logged with it
ROUTER_METRICS = ("load_balance", "router_z", "moe_dropped")
RANKS_SLICE = ("the slice of the port that trains across ranks (ROADMAP.md, "
               "slice 4)")


def resolve_sharding(sharding, streamed: bool = False) -> ShardingPolicy:
    """CLI/ctor spelling -> ShardingPolicy (``None``/``"replicated"``, or a
    ready policy); the FSDP spellings raise, naming their slice."""
    if isinstance(sharding, ShardingPolicy) and not streamed:
        return sharding
    if (sharding is None or sharding == "replicated") and not streamed:
        return REPLICATED
    if streamed or sharding in ("fsdp", "fsdp_streamed"):
        raise NotImplementedError(
            f"sharding {sharding!r}{' streamed' if streamed else ''} is not "
            f"ported yet; it belongs to {FSDP_SLICE}")
    raise ValueError(f"unknown sharding {sharding!r}; options: replicated | "
                     f"ShardingPolicy(...)")


class Trainer:
    def __init__(self, cfg, data_axis: int, *, device="cuda",
                 averager="wagma", group_size=None, tau=10, optimizer="sgd",
                 learning_rate=0.1, momentum=0.9, seq_len=512,
                 global_batch=None, seed=0, microbatch=None, imbalanced=False,
                 topology=None, sharding=None, streamed=False,
                 init_state=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(cfg, device=self.device)
        self.n_dp = int(data_axis)
        names, sizes = ("data",), (self.n_dp,)
        self.sharding = resolve_sharding(sharding, streamed=streamed)
        kw = {}
        if averager == "wagma":
            kw = {"group_size": group_size, "tau": tau}
        elif averager == "local_sgd":
            kw = {"sync_period": tau}
        if topology is not None:
            kw["topology"] = topology
        kw["sharding"] = self.sharding
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
        # replica-steps whose optimiser update the non-finite guard skipped
        self.skipped_nonfinite = 0.0
        self.last_metrics = {}

    def _put_state(self, state: ReplicaState) -> ReplicaState:
        """The state's params and moments on this run's device (the count
        stays on the host), checked against the replica count."""
        rows = tr.tree_leaves(state.params)[0].shape[0]
        if rows != self.n_dp:
            raise ValueError(f"state has {rows} replica rows; this run has "
                             f"{self.n_dp}")
        put = lambda t: tr.tree_map(lambda a: a.to(self.device), t)
        return ReplicaState(put(state.params),
                            map_opt_state(state.opt_state, put,
                                          lambda c: c.cpu()),
                            state.step, state.phase)

    def plan(self):
        """The compiled AveragingPlan the train step executes."""
        return self.averager.plan_for(self.state.params)

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
        """The global batch of step ``t`` on the device; the step gives
        replica r rows ``[r*b, (r+1)*b)``."""
        nb = self.batch_fn(t, 0, self.shape.global_batch)
        return {k: torch.as_tensor(
                    v, dtype=(torch.int64 if np.issubdtype(v.dtype, np.integer)
                              else torch.float32)).to(self.device)
                for k, v in nb.items()}

    def step_once(self, t: int) -> float:
        """Run global step ``t`` (data, variant dispatch, update); returns
        the loss (mean over replicas)."""
        batch = self._put_batch(t)
        step = self._step_fn(t)
        self.state, metrics = step(self.state, batch)
        self.last_metrics = {k: float(v) for k, v in metrics.items()}
        self.skipped_nonfinite += \
            self.last_metrics.get("skipped_nonfinite", 0.0) * self.n_dp
        return self.last_metrics["loss"]

    def run(self, steps: int, log_every: int = 10):
        history = []
        t0 = time.time()
        for t in range(steps):
            loss = self.step_once(t)
            history.append(loss)
            if log_every and (t % log_every == 0 or t == steps - 1):
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
                    help="the number of replicas (rows of the stacked state)")
    ap.add_argument("--model-axis", type=int, default=None)
    ap.add_argument("--pod-axis", type=int, default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--pod-dcn", action="store_true")
    ap.add_argument("--sharding", default="replicated",
                    choices=["replicated", "fsdp"])
    ap.add_argument("--streamed", action="store_true")
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--imbalanced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args()

    if (args.pod_axis or args.multi_pod or args.pod_dcn
            or (args.model_axis or 1) > 1):
        raise NotImplementedError(
            "--pod-axis, --multi-pod, --pod-dcn and --model-axis > 1 lay "
            f"replicas over several devices; that belongs to {RANKS_SLICE}")
    if args.ckpt_dir:
        raise NotImplementedError(
            f"--ckpt-dir: checkpoints belong to {RANKS_SLICE}")
    if not args.data_axis:
        raise SystemExit("give --data-axis: the number of replicas")

    cfg = get_config(args.arch, smoke=args.smoke)
    tr_ = Trainer(cfg, args.data_axis,
                  device=os.environ.get("REPRO_TORCH_DEVICE", "cuda"),
                  averager=args.averager, group_size=args.group_size,
                  tau=args.tau, optimizer=args.optimizer,
                  learning_rate=args.lr, seq_len=args.seq_len,
                  global_batch=args.global_batch, microbatch=args.microbatch,
                  imbalanced=args.imbalanced,
                  sharding=args.sharding, streamed=args.streamed)
    hist = tr_.run(args.steps)
    print(f"final loss {hist[-1]:.4f} (start {hist[0]:.4f})")


if __name__ == "__main__":
    main()
