"""Paper Fig. 5's experiment: WAGMA-SGD under injected stragglers against
Allreduce-SGD, on one device, through ``core/staleness.py``.

``P`` workers of one model (one seeded init, stacked as rows) each take a
local SGD step (momentum 0.9) an iteration on their own rows of the
synthetic batch.  ``StragglerModel(P, n_stragglers=2, p_stall=0.25,
seed)`` draws which workers are late.  Mode ``"wagma"`` averages through
``staleness.wagma_sim_step`` (group allreduce with stale buffers, the
global sync every ``tau``); mode ``"allreduce"`` takes the global mean of
the local updates every iteration (``global_average_stacked``), as the JAX
package's ``tests/test_system.py`` runs its baseline.  As there, the
workers' gradients are one ``vmap`` of the loss's gradient over the stacked
models (without recomputation, which changes no value) and their SGD
updates one update of the stacked trees.

    run(cfg, "wagma", replicas=16, group_size=4, tau=10, steps=40,
        seq_len=256, rows=4, learning_rate=0.1)
"""

from __future__ import annotations

import time

import numpy as np
import torch

MODES = ("wagma", "allreduce")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _put(batch: dict, device) -> dict:
    """A numpy batch on ``device``: integers int64, floats float32, as the
    Trainer puts it."""
    return {k: torch.as_tensor(v, dtype=(
        torch.int64 if np.issubdtype(v.dtype, np.integer)
        else torch.float32)).to(device) for k, v in batch.items()}


def run(cfg, mode: str, *, replicas: int, group_size: int, tau: int,
        steps: int, seq_len: int, rows: int, learning_rate: float,
        seed: int = 0, device="cuda") -> dict:
    """One run of ``steps`` iterations under ``mode``.  Returns each
    iteration's loss (the mean over workers), its wall ms and the number of
    worker draws that did not complete."""
    from repro_torch.configs.base import InputShape
    from repro_torch.core import staleness
    from repro_torch.core.group_allreduce import global_average_stacked
    from repro_torch.data import make_batch_fn
    from repro_torch.models.registry import build_model
    from repro_torch.optim import sgd
    from repro_torch.train import train_step

    if mode not in MODES:
        raise ValueError(f"mode {mode!r}; options: {MODES}")
    model = build_model(cfg, device=device)
    opt = sgd(learning_rate, momentum=0.9)
    gen = torch.Generator(device=device).manual_seed(seed)
    state = staleness.init_state(train_step.stacked_init(model, replicas,
                                                         gen))
    held = {"opt": opt.init(state.models)}
    grads_and_losses = torch.func.vmap(torch.func.grad_and_value(
        lambda params, batch: model.loss(params, batch, remat=False)[0]))
    batch_fn = make_batch_fn(cfg, InputShape("fig5", seq_len,
                                             replicas * rows, "train"),
                             seed=seed)
    strag = staleness.StragglerModel(replicas, n_stragglers=2, p_stall=0.25,
                                     seed=seed)
    losses, step_ms, stalled = [], [], 0
    for t in range(steps):
        batch = {k: v.reshape((replicas, rows) + v.shape[1:]) for k, v in
                 _put(batch_fn(t, 0, replicas * rows), device).items()}

        def local_update(models):
            grads, held["loss"] = grads_and_losses(models, batch)
            new, held["opt"] = opt.update(grads, held["opt"], models)
            return new

        ready, completes = strag.sample()
        stalled += int((~completes).sum())
        _sync(device)
        t0 = time.perf_counter()
        if mode == "wagma":
            state = staleness.wagma_sim_step(
                state, local_update, P=replicas, S=group_size, tau=tau,
                ready=ready, completes=completes, t=t)
        else:
            state = state._replace(models=global_average_stacked(
                local_update(state.models), P=replicas))
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(held["loss"].mean()))
    return {"mode": mode, "losses": losses, "step_ms": step_ms,
            "stalled": stalled}
