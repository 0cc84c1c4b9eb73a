"""recurrentgemma training and the chunked cross-entropy against the JAX
package, on the CPU in float32 from the same numpy inputs.

- The differentiable RG-LRU scan ``ops.rglru_scan_train``: its output and
  its gradients for a, x and h0 against ``jax.value_and_grad`` through the
  JAX model's ``rglru_scan`` (an associative scan), to ``SCAN_RTOL`` of each
  output's largest magnitude.
- The loss and its gradient for every leaf against ``jax.value_and_grad``
  of the JAX ``model.loss``, with remat on and off, to ``RTOL`` of each
  leaf's largest magnitude: recurrentgemma with a tail of recurrent layers,
  with a local window that bites, and, at a vocab of 65536, through
  ``_chunked_ce`` (also qwen3-0.6b) with a mask and 8 or 7 chunks.
- Six steps of the port's ``Trainer`` on recurrentgemma against the JAX
  ``Trainer`` (P = 4, S = 2, tau = 5), which runs once, in a subprocess.

Weights come from the JAX init and cross as numpy (``params_from_jax``).
The JAX reference runs without a mesh, except its Trainer (Auto axes,
ROADMAP.md F1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.rglru as jax_rglru
from jax_trainer_runs import check_trainer_matches, jax_state, \
    one_torch_thread, run_jax_trainers  # noqa: F401  (an autouse fixture)
from repro.configs import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.core import tree as tr
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as rg
from repro_torch.models import common as cm
from repro_torch.models import registry, rglru
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import params_from_jax, replica_state_from_jax

ARCH = "recurrentgemma-2b"
# The associative scan sums the same products in another order (a tree of
# depth log2 S); over S <= 300 steps with |a| < 1 each output moves by a few
# float32 roundings of its magnitude, measured <= 2.1e-7 of each output's
# largest: 1e-5 leaves room without hiding a wrong term.
SCAN_RTOL = 1e-5
# the loss and every gradient leaf, as tests/test_torch_train.py holds the
# dense family (measured <= 4e-6 of each leaf's largest magnitude)
RTOL = 1e-5


# ---------------------------------------------------------------------------
# The scan
# ---------------------------------------------------------------------------

# tests/test_kernels.py's RGLRU_CASES (b, s, w, with_h0), S = 1 with and
# without h0, and a ragged W
SCAN_CASES = [(3, 200, 96, True), (1, 17, 130, False), (8, 128, 128, True),
              (2, 300, 64, False), (2, 1, 8, True), (2, 1, 8, False),
              (2, 37, 1001, True)]


def _scan_inputs(case, seed=0):
    b, s, w, with_h0 = case
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 0.999, (b, s, w)).astype(np.float32)
    x = (rng.standard_normal((b, s, w)) * 0.1).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32) if with_h0 else None
    dh = rng.standard_normal((b, s, w)).astype(np.float32)
    return a, x, h0, dh


@pytest.mark.parametrize("case", SCAN_CASES)
def test_scan_train_matches_jax_value_and_grad(case):
    a, x, h0, dh = _scan_inputs(case)
    with_h0 = h0 is not None

    def f(a, x, *h0):
        h = jax_rglru.rglru_scan(a, x, *h0)
        return (h * dh).sum(), h

    args = [jnp.asarray(v) for v in (a, x, h0) if v is not None]
    (_, jh), jgrads = jax.jit(jax.value_and_grad(
        f, argnums=tuple(range(len(args))), has_aux=True))(*args)
    ins = [torch.from_numpy(v).requires_grad_(True)
           for v in (a, x, h0) if v is not None]
    h = ops.rglru_scan_train(*ins, *([] if with_h0 else [None]))
    grads = torch.autograd.grad(h, ins, torch.from_numpy(dh))
    for got, want in zip((h.detach(),) + grads, (jh,) + tuple(jgrads)):
        want = np.asarray(want)
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=SCAN_RTOL,
                                   atol=SCAN_RTOL * scale)


def test_scan_train_runs_both_scans_through_the_device_scan(monkeypatch):
    """On CPU tensors the forward and the backward scan are both
    ``rglru_scan_plain`` and nothing is counted as a K4 launch; the
    backward scan takes ``flip(a_next)`` and ``flip(dh)``; and
    ``ops.rglru_scan`` still refuses gradients."""
    a, x, h0, dh = _scan_inputs((2, 9, 8, True), seed=3)
    calls = []
    plain = rg.rglru_scan_plain

    def spy(a, x, h0=None):
        calls.append((a.clone(), x.clone(), h0))
        return plain(a, x, h0)

    monkeypatch.setattr(rg, "rglru_scan_plain", spy)
    ops.reset_launch_counts()
    ta, tx, th = (torch.from_numpy(v).requires_grad_(True)
                  for v in (a, x, h0))
    h = ops.rglru_scan_train(ta, tx, th)
    assert len(calls) == 1 and torch.equal(calls[0][2], th)
    h.backward(torch.from_numpy(dh))
    assert len(calls) == 2
    ra, rx, rh0 = calls[1]
    assert rh0 is None
    assert torch.equal(ra[:, 0], torch.zeros_like(ra[:, 0]))
    assert torch.equal(ra[:, 1:], ta.detach()[:, 1:].flip(1))
    assert torch.equal(rx, torch.from_numpy(dh).flip(1))
    assert all(n == 0 for n in ops.launch_counts().values())
    assert torch.equal(tx.grad, plain(ra, rx).flip(1))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rglru_scan(ta, tx, th)


# ---------------------------------------------------------------------------
# The loss and its gradients
# ---------------------------------------------------------------------------

def _cfgs(arch, **kw):
    return (get_config(arch, smoke=True).variant(dtype="float32", **kw),
            jax_config(arch, smoke=True).variant(dtype="float32", **kw))


BIG = 65536                           # the chunked cross-entropy's switch


@pytest.mark.parametrize("arch,kw,seq,window", [
    (ARCH, dict(n_layers=5), 48, None),
    # a window of 16 over 48 tokens in 16-token blocks
    (ARCH, dict(n_layers=5, attn_block_q=16, attn_block_k=16), 48, 16),
    (ARCH, dict(n_layers=5, vocab=BIG), 48, None),          # 8 chunks
    (ARCH, dict(n_layers=5, vocab=BIG), 42, None),          # 7 chunks
    ("qwen3-0.6b", dict(vocab=BIG), 48, None),
    ("qwen3-0.6b", dict(vocab=BIG), 42, None),
], ids=["rg-tail", "rg-window16", "rg-chunked-S48", "rg-chunked-S42",
        "qwen3-chunked-S48", "qwen3-chunked-S42"])
def test_loss_and_grads_match_jax_value_and_grad(arch, kw, seq, window,
                                                 monkeypatch):
    if window is not None:
        monkeypatch.setattr(jax_rglru, "ATTN_WINDOW", window)
        monkeypatch.setattr(rglru, "ATTN_WINDOW", window)
    cfg, jcfg = _cfgs(arch, **kw)
    assert (cfg.vocab_padded >= registry.CHUNKED_CE_VOCAB) == \
        (kw.get("vocab") == BIG)
    jm = jax_build(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, seq + 1)).astype(np.int32)
    mask = (rng.random((2, seq)) > 0.2).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks[:, :-1]),
              "labels": jnp.asarray(toks[:, 1:]), "mask": jnp.asarray(mask)}
    # a fresh lambda: no trace cached under another window is reused
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(jparams, jbatch)
    model = registry.build_model(cfg, device="cpu")
    batch = {k: torch.as_tensor(np.array(v)) for k, v in jbatch.items()}
    for remat in (True, False):
        leaves, treedef = tr.tree_flatten(params_from_jax(
            cfg, jax.tree.map(np.asarray, jparams), "cpu"))
        leaves = [l.requires_grad_(True) for l in leaves]
        loss, metrics = model.loss(tr.tree_unflatten(treedef, leaves), batch,
                                   remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL,
                                   atol=RTOL)
        assert metrics["ce"] is metrics["loss"]
        jleaves = jax.tree.leaves(jgrads)
        assert len(jleaves) == len(grads)
        for g, jg in zip(grads, jleaves):
            jg = np.asarray(jg)
            scale = float(np.abs(jg).max()) or 1.0
            np.testing.assert_allclose(g.numpy(), jg, rtol=RTOL,
                                       atol=RTOL * scale)


@pytest.mark.parametrize("seq,chunks", [(48, 8), (42, 7), (13, 1)])
def test_chunked_ce_never_builds_the_whole_logits(seq, chunks, monkeypatch):
    """Every unembed, forward and recomputed in the backward, sees one
    chunk of S / chunks positions; the chunks are the JAX rule's (8, one
    fewer until the count divides S); the result is the unchunked
    cross-entropy, with and without a mask."""
    cfg = get_config(ARCH, smoke=True).variant(dtype="float32", vocab=BIG)
    params = rglru.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    emb = params["emb"].requires_grad_(True)
    rng = np.random.default_rng(2)
    hidden = torch.from_numpy(rng.standard_normal(
        (2, seq, cfg.d_model)).astype(np.float32)).requires_grad_(True)
    labels = torch.from_numpy(rng.integers(0, cfg.vocab, (2, seq)))
    mask = torch.from_numpy((rng.random((2, seq)) > 0.3).astype(np.float32))
    widths = []
    unembed = tfm.unembed

    def spy(cfg_, p, x):
        widths.append(x.shape[1])
        return unembed(cfg_, p, x)

    monkeypatch.setattr(tfm, "unembed", spy)
    for m in (mask, None):
        widths.clear()
        ce = registry._chunked_ce(cfg, params, hidden, labels, m)
        assert widths == [seq // chunks] * chunks
        ce.backward()
        assert widths == [seq // chunks] * 2 * chunks
        want = cm.softmax_cross_entropy(unembed(cfg, params, hidden).detach(),
                                        labels, m)
        np.testing.assert_allclose(ce.item(), want.item(), rtol=1e-6)
    assert emb.grad is not None and hidden.grad is not None


def test_replica_state_from_jax_carries_the_tail():
    """A hybrid JAX ReplicaState with a tail (n_layers = 5) crosses leaf for
    leaf: params stacked in cfg.dtype (``lam`` float32), momentum float32,
    the ``tail`` subtree included."""
    cfg = get_config(ARCH, smoke=True).variant(n_layers=5)
    jcfg = jax_config(ARCH, smoke=True).variant(n_layers=5)
    one = jax.tree.map(np.asarray, jax_rglru.init_params(
        jcfg, jax.random.PRNGKey(0)))
    # -a and 2a are exact in every dtype
    stack = lambda t: jax.tree.map(lambda a: np.stack([a, -a, a * 2]), t)
    params = stack(one)
    momentum = jax.tree.map(lambda a: a.astype(np.float32) * 0.5, params)
    res = {}
    for tag, tree in (("params0", params), ("momentum0", momentum)):
        for path, v in jax.tree_util.tree_leaves_with_path(tree):
            res["r/" + tag + "/" + "/".join(k.key for k in path)] = v
    state = replica_state_from_jax(cfg, jax_state(res, "r", 0, 3), "cpu")
    assert set(state.params) == {"emb", "blocks", "ln_f", "tail"}
    assert state.params["tail"]["w_x"].shape == (3, 2, cfg.d_model,
                                                cfg.lru_width)
    assert state.params["tail"]["lam"].dtype == torch.float32
    assert state.params["tail"]["w_x"].dtype == torch.bfloat16
    for got, want in ((state.params, params),
                      (state.opt_state.momentum, momentum)):
        for g, w in zip(tr.tree_leaves(got), jax.tree.leaves(want)):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g.float().numpy(),
                                          w.astype(np.float32))
    assert all(m.dtype == torch.float32
               for m in tr.tree_leaves(state.opt_state.momentum))


# ---------------------------------------------------------------------------
# Six Trainer steps against the JAX Trainer
# ---------------------------------------------------------------------------

P, S, TAU, SEQ, GB, STEPS = 4, 2, 5, 16, 8, 6
TRAINER_KW = dict(group_size=S, tau=TAU, seq_len=SEQ, global_batch=GB, seed=0)


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory):
    outp = str(tmp_path_factory.mktemp("train_hybrid") / "jax.npz")
    return run_jax_trainers(
        {"rg": (ARCH, dict(n_layers=5), P, TRAINER_KW, STEPS)}, outp,
        devices=P)


def test_six_hybrid_trainer_steps_match_jax_trainer(jax_trainer):
    """All phase offsets and the tau-sync at t = 4; the port's per-replica
    loop over the rows against the JAX step over a 4-device mesh."""
    cfg, _ = _cfgs(ARCH, n_layers=5)
    trainer = check_trainer_matches(jax_trainer, "rg", cfg, P, TRAINER_KW,
                                    STEPS, RTOL)
    assert ("sync",) in trainer._steps
    assert trainer.averager.n_phases + 1 == len(trainer._steps)
