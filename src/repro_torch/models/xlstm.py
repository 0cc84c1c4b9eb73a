"""xLSTM (arXiv:2405.04517): alternating mLSTM / sLSTM blocks, counterpart of
``repro/models/xlstm.py``.

Config ``xlstm-350m``: 24 layers, d_model=1024, 4 heads, no FFN (d_ff=0):
the blocks' own up/down projections carry the MLP role.

* mLSTM: matrix-memory LSTM with exponential gating.  State per head: C
  (dh x dh), n (dh) and the stabiliser m (a scalar), all float32.
* sLSTM: scalar-memory LSTM with recurrent per-head (block-diagonal)
  weights; state c, n, m and h, each (dh) per head.

Both recurrences run as a Python loop over time steps in plain torch, one
``mlstm_step`` or sLSTM step a token, as the JAX module runs them as a
``lax.scan`` in plain ``jnp``: the reference has no kernel here, and
neither does the port.  On the card the loop is bound by the host: each
token issues some 40 small torch ops a superblock (elementwise ops and
batched matrix-vector products).

Parameters are a dict with the JAX package's tree and layouts: ``emb``,
``blocks/mlstm/*`` and ``blocks/slstm/*`` stacked on a leading superblock
axis of ``n_layers // 2``, and ``ln_f``; ``bif`` and ``bg`` are float32
whatever ``cfg.dtype`` is.  ``bg`` is laid out gate-major (z and i zero,
f 3, o zero, each ``d`` long) but read head-major, as the reference reads
it: at 4 heads head 2's four gates all start at 3.  Serving state is the
recurrent state (O(1) a token): ``prefill`` returns it, ``decode_step``
writes it in place.

**The model axis.**  Every entry point takes ``mw``, the model world of
one replica (``common.ModelWorld``), or ``None``; a rank computes
``n_heads / mw.size`` whole heads (:func:`heads_held`).  Both blocks'
gates are head-major, so the placement's even column splits hand each
rank whole heads: ``wq``/``wk``/``wv`` and sLSTM's ``wg`` by column,
``w_down`` by row.  The exception is mLSTM's ``w_up``, whose columns are
``[inner | z]``: a rank's columns go through ``common.gather_from_model``,
and each rank reads ``inner`` whole and the ``z`` columns of its heads.
The leaves held whole (``wif``, ``bif``, ``bg``, ``r``, the norms) are
read at the rank's heads under ``copy_to_model``, so that their
gradients are whole; each block's input passes ``copy_to_model`` and its
``w_down`` product ``reduce_from_model``.  The embedding is split by
vocab, as the dense family's.  A rank's state holds its heads, and no
collective runs inside a time loop.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.tree import Spec
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm

PROJ_FACTOR = 2       # mLSTM inner width = 2 * d_model
M_INIT = -1e30        # the stabiliser's start, never -inf
BIF, BG = "bif", "bg"  # the float32 gate biases' deterministic inits


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def _param_tree(cfg, leaf):
    """The param tree with each leaf made by ``leaf(shape, init)``: init is
    the std of a normal init, None for a zero leaf, or ``BIF``/``BG``."""
    if cfg.n_layers % 2:
        raise ValueError(f"xLSTM needs an even layer count, got "
                         f"{cfg.n_layers}")
    d, H = cfg.d_model, cfg.n_heads
    di = PROJ_FACTOR * d
    dh = d // H
    lead = (cfg.n_layers // 2,)

    def dense(d_in, d_out, std=None):
        return leaf(lead + (d_in, d_out), std or 1.0 / math.sqrt(d_in))

    mlstm = {
        "ln": {"scale": leaf(lead + (d,), None)},
        "w_up": dense(d, 2 * di),                  # [inner | z gate]
        "wq": dense(di, di), "wk": dense(di, di), "wv": dense(di, di),
        "wif": dense(di, 2 * H, 0.01),
        "bif": leaf(lead + (2 * H,), BIF),
        "w_down": dense(di, d),
    }
    slstm = {
        "ln": {"scale": leaf(lead + (d,), None)},
        "wg": dense(d, 4 * d),                     # z, i, f, o gates
        "r": leaf(lead + (H, dh, 4 * dh), 1.0 / math.sqrt(dh)),
        "bg": leaf(lead + (4 * d,), BG),
        "w_down": dense(d, d),
    }
    return {"emb": leaf((cfg.vocab_padded, d), 0.02),
            "blocks": {"mlstm": mlstm, "slstm": slstm},
            "ln_f": {"scale": leaf((d,), None)}}


def param_shapes(cfg):
    """The param tree with each leaf's shape tuple in place of a tensor."""
    return _param_tree(cfg, lambda shape, init: tuple(shape))


def param_specs(cfg):
    """The param tree with each leaf's shape and dtype (``bif`` and ``bg``
    float32)."""
    dtype = tfm.torch_dtype(cfg)
    return _param_tree(cfg, lambda shape, init: Spec(
        tuple(shape), torch.float32 if init in (BIF, BG) else dtype))


def _bias(init, width: int) -> torch.Tensor:
    """The JAX init's gate biases: ``bif`` (i, f) = (0, 3) per head;
    ``bg`` 0 for z and i, 3 for f, 0 for o, each ``width // 4`` long."""
    if init == BIF:
        return torch.tensor([0.0, 3.0]).repeat(width // 2)
    d = width // 4
    return torch.cat([torch.zeros(2 * d), torch.full((d,), 3.0),
                      torch.zeros(d)])


def init_params(cfg, generator: torch.Generator, device="cuda", mw=None):
    """Random weights with the JAX init's distributions: N(0, 1/d_in) dense
    kernels, N(0, 0.01^2) for ``wif``, N(0, 1/dh) recurrent ``r``,
    N(0, 0.02^2) embeddings, zero norm scales and the deterministic float32
    gate biases.  Numbers are drawn on the generator's device, one leaf at a
    time.  With a model world every leaf is drawn whole, as without, and
    only the rank's slice of it is kept (``common.dims_in_order``)."""
    dtype = tfm.torch_dtype(cfg)
    dims = iter(cm.dims_in_order(cfg, _param_tree, mw.size)
                if mw is not None else ())

    def whole(shape, init):
        if init in (BIF, BG):
            return _bias(init, shape[-1]).to(device).expand(shape).clone()
        if init is None:
            return torch.zeros(shape, dtype=dtype, device=device)
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * init
        return x.to(device=device, dtype=dtype)

    def leaf(shape, init):
        a, dim = whole(shape, init), next(dims, None)
        if dim is None:
            return a
        n = shape[dim] // mw.size
        return a.narrow(dim, mw.rank * n, n).clone()

    return _param_tree(cfg, leaf)


def heads_held(cfg, mw) -> int:
    """The heads a rank computes: ``n_heads / mw.size``, all without a
    model world.  A model axis that does not divide the heads raises: the
    placement's even splits would then cut a head."""
    if mw is None:
        return cfg.n_heads
    if cfg.n_heads % mw.size:
        raise ValueError(f"xLSTM's {cfg.n_heads} heads do not divide over "
                         f"{mw.size} model ranks")
    return cfg.n_heads // mw.size


def _rank_cols(a, mw, width: int):
    """The rank's ``width`` columns (last dim) of a leaf held whole, under
    ``copy_to_model`` so that its gradient is whole."""
    if mw is None:
        return a
    return cm.copy_to_model(a, mw).narrow(-1, mw.rank * width, width)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def _mlstm_preacts(cfg, p, x, mw=None):
    """q, k, v, the i and f pre-activations and the z gate of the heads the
    rank computes (all of them without a model world)."""
    b, s, d = x.shape
    H, hl = cfg.n_heads, heads_held(cfg, mw)
    di = PROJ_FACTOR * d
    dh = di // H
    h = cm.copy_to_model(cm.rms_norm(x, p["ln"]["scale"], cfg.norm_eps), mw)
    inner, z = cm.gather_from_model(h @ p["w_up"], mw).chunk(2, dim=-1)
    if mw is not None:
        z = z.narrow(-1, mw.rank * hl * dh, hl * dh)
    q = (inner @ p["wq"]).reshape(b, s, hl, dh)
    # the key's scale is taken in the activations' dtype, as in JAX
    k = (inner @ p["wk"]).reshape(b, s, hl, dh) / torch.tensor(
        math.sqrt(float(dh)), dtype=torch.float32).to(x.dtype)
    v = (inner @ p["wv"]).reshape(b, s, hl, dh)
    wif, bif = (_rank_cols(p[n], mw, 2 * hl) for n in ("wif", "bif"))
    gates = ((inner @ wif).float() + bif).reshape(b, s, hl, 2)
    return q, k, v, gates[..., 0], gates[..., 1], z


def mlstm_step(state, qkvif):
    """One timestep; state = (C (B,H,dh,dh), n (B,H,dh), m (B,H)), all
    float32; qkvif = (q, k, v (B,H,dh), i_pre, f_pre (B,H))."""
    C, n, m = state
    q, k, v, i_pre, f_pre = qkvif
    logf = F.logsigmoid(f_pre)                              # (B,H)
    m_new = torch.maximum(logf + m, i_pre)
    decay = torch.exp(logf + m - m_new)
    inp = torch.exp(i_pre - m_new)
    q32, k32, v32 = q.float(), k.float(), v.float()
    C = decay[..., None, None] * C + inp[..., None, None] * (
        v32[..., :, None] * k32[..., None, :])             # v outer k
    n = decay[..., None] * n + inp[..., None] * k32
    num = torch.einsum("bhij,bhj->bhi", C, q32)
    den = torch.maximum(torch.einsum("bhj,bhj->bh", n, q32).abs(),
                        torch.exp(-m_new))
    h = num / den[..., None]
    return (C, n, m_new), h


def mlstm_init_state(batch: int, H: int, dh: int, device):
    return (torch.zeros((batch, H, dh, dh), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, H, dh), dtype=torch.float32, device=device),
            torch.full((batch, H), M_INIT, dtype=torch.float32,
                       device=device))


def mlstm_block(cfg, p, x, state=None, mw=None):
    """x (B,S,d) -> (x + out, final state): one ``mlstm_step`` a token,
    over the rank's heads with a model world (``w_down``'s partial
    product summed over the ranks)."""
    b, s, d = x.shape
    q, k, v, i_pre, f_pre, z = _mlstm_preacts(cfg, p, x, mw)
    # the step's float32 casts, once for the whole sequence
    q, k, v = q.float(), k.float(), v.float()
    if state is None:
        state = mlstm_init_state(b, heads_held(cfg, mw),
                                 PROJ_FACTOR * d // cfg.n_heads, x.device)
    hs = []
    for t in range(s):
        state, h = mlstm_step(state, (q[:, t], k[:, t], v[:, t],
                                      i_pre[:, t], f_pre[:, t]))
        hs.append(h)
    hs = torch.stack(hs, dim=1).reshape(b, s, -1)        # (B,S,di/M)
    out = cm.reduce_from_model((hs.to(x.dtype) * F.silu(z)) @ p["w_down"],
                               mw)
    return x + out, state


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_step_fn(p, H: int, dh: int, mw=None):
    """The sLSTM step over state (c, n, m, h), each (B,H,dh) float32, and
    one token's gate pre-activations (B,H,4dh); the recurrent weights are
    applied per head in float32 (with a model world ``H`` is the rank's
    heads, and ``r`` is read at them)."""
    r = p["r"]
    if mw is not None:
        r = cm.copy_to_model(r, mw).narrow(0, mw.rank * H, H)
    r = r.float()

    def step(state, x_gates):
        c, n, m, h_prev = state
        rec = torch.einsum("bhd,hdf->bhf", h_prev, r)       # (B,H,4dh)
        z, i_pre, f_pre, o_pre = (x_gates + rec).chunk(4, dim=-1)
        logf = F.logsigmoid(f_pre)
        m_new = torch.maximum(logf + m, i_pre)
        decay = torch.exp(logf + m - m_new)
        inp = torch.exp(i_pre - m_new)
        c = decay * c + inp * torch.tanh(z)
        n = decay * n + inp
        h = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
        return (c, n, m_new, h), h

    return step


def slstm_init_state(batch: int, H: int, dh: int, device):
    zero = lambda: torch.zeros((batch, H, dh), dtype=torch.float32,
                               device=device)
    return (zero(), zero(), torch.full((batch, H, dh), M_INIT,
                                       dtype=torch.float32, device=device),
            zero())


def slstm_block(cfg, p, x, state=None, mw=None):
    """x (B,S,d) -> (x + out, final state): one sLSTM step a token, over
    the rank's heads with a model world."""
    b, s, d = x.shape
    H = heads_held(cfg, mw)
    dh = d // cfg.n_heads
    hnorm = cm.copy_to_model(cm.rms_norm(x, p["ln"]["scale"], cfg.norm_eps),
                             mw)
    bg = _rank_cols(p["bg"], mw, 4 * H * dh)
    gates = ((hnorm @ p["wg"]).float() + bg).reshape(b, s, H, 4 * dh)
    if state is None:
        state = slstm_init_state(b, H, dh, x.device)
    step = slstm_step_fn(p, H, dh, mw)
    hs = []
    for t in range(s):
        state, h = step(state, gates[:, t])
        hs.append(h)
    hs = torch.stack(hs, dim=1).reshape(b, s, H * dh)
    return x + cm.reduce_from_model(hs.to(x.dtype) @ p["w_down"], mw), state


# ---------------------------------------------------------------------------
# Forward / serving
# ---------------------------------------------------------------------------

def _superblock(cfg, bp, x, ms=None, ss=None, mw=None):
    """One (mLSTM, sLSTM) pair -> (x, mLSTM state, sLSTM state)."""
    x, ms = mlstm_block(cfg, bp["mlstm"], x, ms, mw)
    x, ss = slstm_block(cfg, bp["slstm"], x, ss, mw)
    return x, ms, ss


def _final(cfg, params, x, mw=None):
    x = cm.rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)
    return tfm.unembed(cfg, params, x, mw)


@torch.no_grad()
def forward(cfg, params, tokens, mw=None):
    """tokens (B,S) -> logits (B,S,V) (the rank's vocab columns with a
    vocab-split model world)."""
    x = tfm.embed(cfg, params, tokens, mw)
    for i in range(cfg.n_layers // 2):
        x = _superblock(cfg, tfm._index(params["blocks"], i), x, mw=mw)[0]
    return _final(cfg, params, x, mw)


def forward_train(cfg, params, tokens, remat: bool = True,
                  return_hidden: bool = False, mw=None):
    """tokens (B,S) -> logits (B,S,V) with autograd: the JAX ``forward``.
    With ``return_hidden`` the hidden state after ``ln_f`` instead.
    ``remat`` recomputes each superblock in the backward
    (``torch.utils.checkpoint``), as ``jax.remat`` wraps the superblock
    body that JAX scans.  With a model world the logits are the rank's
    vocab columns; the hidden state is whole."""
    x = tfm.embed(cfg, params, tokens, mw)

    def superblock(x, bp):
        return _superblock(cfg, bp, x, mw=mw)[0]

    for i in range(cfg.n_layers // 2):
        bp = tfm._index(params["blocks"], i)
        x = (checkpoint(superblock, x, bp, use_reentrant=False) if remat
             else superblock(x, bp))
    x = cm.rms_norm(x, params["ln_f"]["scale"], cfg.norm_eps)
    return x if return_hidden else tfm.unembed(cfg, params, x, mw)


def init_caches(cfg, batch: int, max_len: int, device="cuda", mw=None):
    """The zero recurrent state of every superblock, stacked on a leading
    axis, of the rank's heads; ``max_len`` plays no part (O(1) state a
    token)."""
    n_sb, H, d = cfg.n_layers // 2, heads_held(cfg, mw), cfg.d_model
    stack = lambda state: tuple(a[None].expand((n_sb,) + a.shape).clone()
                                for a in state)
    return {"mlstm": stack(mlstm_init_state(
                batch, H, PROJ_FACTOR * d // cfg.n_heads, device)),
            "slstm": stack(slstm_init_state(batch, H, d // cfg.n_heads,
                                            device))}


@torch.no_grad()
def prefill(cfg, params, tokens, max_len: Optional[int] = None, mw=None):
    """Run the prompt (B,S) through; returns (last-token logits, the final
    states as the caches): the rank's heads and vocab columns with a model
    world."""
    x = tfm.embed(cfg, params, tokens, mw)
    ms_all, ss_all = [], []
    for i in range(cfg.n_layers // 2):
        x, ms, ss = _superblock(cfg, tfm._index(params["blocks"], i), x,
                                mw=mw)
        ms_all.append(ms)
        ss_all.append(ss)
    stack = lambda states: tuple(torch.stack(parts) for parts in zip(*states))
    caches = {"mlstm": stack(ms_all), "slstm": stack(ss_all)}
    return _final(cfg, params, x[:, -1:], mw), caches


@torch.no_grad()
def decode_step(cfg, params, caches, token, pos=None, mw=None):
    """token (B,1) int -> (logits (B,1,V), caches); the states are written
    in place and returned.  ``pos`` plays no part."""
    x = tfm.embed(cfg, params, token, mw)
    for i in range(cfg.n_layers // 2):
        ms = tuple(a[i] for a in caches["mlstm"])
        ss = tuple(a[i] for a in caches["slstm"])
        x, ms_new, ss_new = _superblock(cfg, tfm._index(params["blocks"], i),
                                        x, ms, ss, mw)
        for dst, src in zip(ms + ss, ms_new + ss_new):
            dst.copy_(src)
    return _final(cfg, params, x, mw), caches
