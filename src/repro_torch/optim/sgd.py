"""SGD with (Nesterov) momentum — the paper's optimiser for all three tasks.

Counterpart of ``repro/optim/sgd.py``.  Momentum buffers are float32
whatever the parameter dtype; weight decay is decoupled from the momentum.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch.core import tree as tr


class SGDState(NamedTuple):
    momentum: object   # tree like params, float32
    count: torch.Tensor


class Optimizer(NamedTuple):
    init: Callable
    update: Callable


def flatten_like(params, *trees):
    """Leaves of ``params`` and of each same-structured tree, plus the
    treedef to rebuild one."""
    leaves, treedef = tr.tree_flatten(params)
    others = []
    for t in trees:
        t_leaves, t_def = tr.tree_flatten(t)
        if t_def != treedef:
            raise ValueError("optimizer: trees of different structure")
        others.append(t_leaves)
    return treedef, leaves, others


def sgd(learning_rate: Union[float, Callable], momentum: float = 0.9,
        nesterov: bool = False, weight_decay: float = 0.0) -> Optimizer:
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params):
        mom = tr.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params)
        return SGDState(momentum=mom, count=torch.zeros((), dtype=torch.int32))

    def update(grads, state: SGDState, params):
        lr = lr_fn(state.count)

        def step(p, g, m):
            g32 = g.float()
            if weight_decay:
                g32 = g32 + weight_decay * p.float()
            m_new = momentum * m + g32
            upd = (g32 + momentum * m_new) if nesterov else m_new
            return (p.float() - lr * upd).to(p.dtype), m_new

        treedef, ps, (gs, ms) = flatten_like(params, grads, state.momentum)
        new = [step(p, g, m) for p, g, m in zip(ps, gs, ms)]
        new_p = tr.tree_unflatten(treedef, [a for a, _ in new])
        new_m = tr.tree_unflatten(treedef, [b for _, b in new])
        return new_p, SGDState(momentum=new_m, count=state.count + 1)

    return Optimizer(init=init, update=update)
