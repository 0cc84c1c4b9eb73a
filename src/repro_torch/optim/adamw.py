"""AdamW with float32 moments.  Counterpart of ``repro/optim/adamw.py``."""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch.core import tree as tr
from repro_torch.optim.sgd import Optimizer, flatten_like


class AdamWState(NamedTuple):
    mu: object
    nu: object
    count: torch.Tensor


def adamw(learning_rate: Union[float, Callable], b1: float = 0.9,
          b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return AdamWState(mu=tr.tree_map(zeros, params),
                          nu=tr.tree_map(zeros, params),
                          count=torch.zeros((), dtype=torch.int32))

    def update(grads, state: AdamWState, params):
        count = state.count + 1
        lr = lr_fn(count)
        c1 = 1.0 - b1 ** count.float()
        c2 = 1.0 - b2 ** count.float()

        def step(p, g, mu, nu):
            g32 = g.float()
            mu_new = b1 * mu + (1 - b1) * g32
            nu_new = b2 * nu + (1 - b2) * g32.square()
            upd = (mu_new / c1) / (torch.sqrt(nu_new / c2) + eps)
            p32 = p.float()
            if weight_decay:
                upd = upd + weight_decay * p32
            return (p32 - lr * upd).to(p.dtype), mu_new, nu_new

        treedef, ps, (gs, mus, nus) = flatten_like(params, grads, state.mu,
                                                   state.nu)
        new = [step(*a) for a in zip(ps, gs, mus, nus)]
        unf = lambda i: tr.tree_unflatten(treedef, [n[i] for n in new])
        return unf(0), AdamWState(mu=unf(1), nu=unf(2), count=count)

    return Optimizer(init=init, update=update)
