"""First-order optimisers in torch (no external deps).

Counterpart of ``repro/optim``.  Optax-like interface:
``opt.init(params) -> state``; ``opt.update(grads, state, params) ->
(new_params, new_state)``.  The update *applies* the step (returns new
params) because WAGMA averages the updated weights W' = W + U(G) (paper
Alg. 2 line 6-7).  Moments are float32 whatever the param dtype.
"""

from repro_torch.optim.sgd import sgd
from repro_torch.optim.adamw import adamw
from repro_torch.optim.schedule import constant, cosine_warmup

__all__ = ["sgd", "adamw", "constant", "cosine_warmup"]
