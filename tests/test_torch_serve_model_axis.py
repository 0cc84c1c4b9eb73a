"""The port's paged ``ServeScheduler`` over model ranks against the JAX
package's scheduler on an Auto-typed ``(1, 2)`` mesh (ROADMAP.md F1) and
against its own one-rank scheduler, on the CPU in float32, at qwen3-0.6b's
smoke config (4 heads over 2 KV heads, qk norms, vocab 512).

One JAX subprocess (2 forced host devices) and two gloo worlds of
``data 1 x model 2`` run side by side from the same port-made weights and
prompts:

- the scheduler serves requests of distinct prompt lengths from a pool
  small enough to preempt; every request's tokens equal the JAX
  scheduler's and the one-rank scheduler's, both ranks hold the same, and
  the admissions, evictions and decode shapes are the one-rank run's;
- the paged steps' greedy pick left rank-local (each rank's argmax of its
  own vocab columns) gives tokens other than the reference's;
- the pinned host buffers through which a model world stages its
  collectives (``ModelWorld.staged``) stay bounded over 20 prompt
  lengths, at most one a power of two and dtype, and a prefill staged
  through them is bit for bit the one that is not;
- the ``DisaggregatedScheduler`` over the ranks gives the JAX
  ``DisaggregatedScheduler``'s tokens and the colocated ones, preemption
  included, each rank shipping half the one-rank run's KV bytes; a
  connector that flips the top exponent bit of request 0's first V
  element on rank 1 alone changes its tokens.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import rank_runs
from jax_trainer_runs import one_torch_thread  # noqa: F401
from subproc import SRC

from repro_torch.checkpoint import save_checkpoint
from repro_torch.models.registry import build_model
from repro_torch.serve.kv_transfer import DisaggregatedScheduler
from repro_torch.serve.scheduler import Request, ServeScheduler

ARCH = "qwen3-0.6b"
# (prompt length, new tokens) a request; a pool of 14 blocks of 4 makes
# the later requests' growth preempt the latest admitted
LENS = [(9, 12), (8, 13), (10, 11), (7, 10)]
SCHED_KW = dict(n_blocks=14, block_size=4, max_blocks_per_req=8,
                max_batch=4)
# the staged prefills' prompt lengths
STAGED_LENGTHS = list(range(3, 63, 3))

JAX_SCHED = """
    from jax.sharding import AxisType
    from repro.configs import get_config
    from repro.models.registry import build_model
    from repro.serve.decode import serve_param_shardings
    from repro.serve.kv_transfer import DisaggregatedScheduler
    from repro.serve.scheduler import Request, ServeScheduler
    out = {out!r}
    cfg = get_config({arch!r}, smoke=True).variant(dtype="float32")
    model = build_model(cfg)
    tree = {{}}
    for key, val in np.load(f"{{out}}/params/params.npz").items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {{}})
        node[parts[-1]] = jnp.asarray(val)
    reqs = np.load(f"{{out}}/prompts.npz")
    mesh = jax.make_mesh((1, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:2])
    with compat.set_mesh(mesh):
        params = jax.device_put(tree, serve_param_shardings(
            mesh, jax.eval_shape(lambda: tree)))
        sched = ServeScheduler(model, params, **{sched_kw!r})
        for k in sorted(reqs, key=int):
            sched.submit(Request(int(k), reqs[k], {lens!r}[int(k)][1]))
        outs = sched.run()
        disagg = DisaggregatedScheduler(model, params, **{sched_kw!r})
        for k in sorted(reqs, key=int):
            disagg.submit(Request(int(k), reqs[k], {lens!r}[int(k)][1]))
        d_outs = disagg.run()
    as_lists = lambda o: {{str(k): [int(t) for t in v] for k, v in o.items()}}
    json.dump({{"tokens": as_lists(outs), "disagg_tokens": as_lists(d_outs),
               "evictions": sched.blocks.evictions,
               "disagg_evictions": disagg.blocks.evictions}},
              open(f"{{out}}/jax.json", "w"))
    print("JAX_SERVE_MODEL_AXIS_DONE")
"""


def _cfg():
    return rank_runs.smoke_cfg(ARCH)


def _one_rank(params_path: str, prompts: dict,
              sched_cls=ServeScheduler) -> ServeScheduler:
    from repro_torch.checkpoint import load_checkpoint
    cfg = _cfg()
    model = build_model(cfg, "cpu")
    params, _ = load_checkpoint(params_path, rank_runs._spec_tree(cfg))
    sched = sched_cls(model, params, **SCHED_KW)
    for k in sorted(prompts, key=int):
        sched.submit(Request(int(k), prompts[k], LENS[int(k)][1]))
    sched.run()
    return sched


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's weights and prompts, the JAX subprocess beside the gloo
    worlds (the scheduler and the disaggregated one, then the rank-local
    pick), and the one-rank schedulers; returns (JAX result, {run:
    per-rank results}, one-rank scheduler, one-rank disaggregated
    scheduler)."""
    out = str(tmp_path_factory.mktemp("serve_model_axis"))
    cfg = _cfg()
    params = os.path.join(out, "params")
    save_checkpoint(params, build_model(cfg, "cpu").init(
        torch.Generator().manual_seed(2)))
    rng = np.random.default_rng(5)
    prompts = {str(i): rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for i, (n, _) in enumerate(LENS)}
    np.savez(os.path.join(out, "prompts.npz"), **prompts)
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        import sys, json
        sys.path.insert(0, {SRC!r})
        import jax, jax.numpy as jnp
        import numpy as np
        from repro import compat
    """) + textwrap.dedent(JAX_SCHED.format(out=out, arch=ARCH,
                                             sched_kw=SCHED_KW, lens=LENS))
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    kw = dict(arch=ARCH, params=params,
              prompts=os.path.join(out, "prompts.npz"), sched_kw=SCHED_KW)
    try:
        ranks = {name: rank_runs.spawn(
            "scheduler", 2, os.path.join(out, name), data=1, model=2,
            new=[n for _, n in LENS], fault=fault,
            staged_lengths=STAGED_LENGTHS if fault is None else [],
            disagg=fault is None, **kw)
            for name, fault in (("sched", None),
                                ("local_pick", "local_pick"))}
        one = _one_rank(params, prompts)
        one_disagg = _one_rank(params, prompts, DisaggregatedScheduler)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0 and "JAX_SERVE_MODEL_AXIS_DONE" in stdout, \
        stderr[-3000:]
    return (json.load(open(os.path.join(out, "jax.json"))), ranks, one,
            one_disagg)


def _tokens(res, prefix: str = "") -> dict:
    return {int(k.split("/")[-1]): [int(t) for t in v]
            for k, v in res.items() if k.startswith(prefix + "tokens/")}


def test_scheduler_over_model_ranks_matches_jax_and_one_rank(runs):
    """Over data 1 x model 2 the scheduler preempts, and every request's
    tokens are the JAX scheduler's on the ``(1, 2)`` mesh and the one-rank
    scheduler's; both ranks hold the same tokens, prefills, decode steps,
    evictions and decode shapes as the one-rank run."""
    want, ranks, one, _ = runs
    jax_tokens = {int(k): v for k, v in want["tokens"].items()}
    one_tokens = {rid: list(r.out) for rid, r in one.finished.items()}
    assert one.blocks.evictions > 0 and want["evictions"] > 0
    assert one_tokens == jax_tokens
    for res in ranks["sched"]:
        assert _tokens(res) == jax_tokens
        assert res["counts"].tolist() == [one.n_prefills, one.n_decode_steps,
                                          one.blocks.evictions]
        assert sorted(map(tuple, res["shapes"].tolist())) == \
            sorted(one.decode_shapes_compiled)
    assert all(len(v) == n for v, (_, n) in
               zip((jax_tokens[i] for i in range(len(LENS))), LENS))


def test_rank_local_greedy_pick_fails(runs):
    """The paged steps' pick left rank-local: each rank picks among its own
    vocab columns, so the tokens part from the reference's (and the two
    ranks' from each other)."""
    want, ranks, _, _ = runs
    jax_tokens = {int(k): v for k, v in want["tokens"].items()}
    got = [_tokens(res) for res in ranks["local_pick"]]
    assert got[0] != jax_tokens and got[1] != jax_tokens
    assert got[0] != got[1]


def test_pinned_host_buffers_stay_bounded(runs):
    """A prefill at each of 20 prompt lengths staged through the host
    buffers: each gives the unstaged prefill's logits and caches bit for
    bit, and the buffers left are one a power-of-two capacity and dtype,
    at most log2 of the largest capacity + 1 a dtype, where one a
    (count, dtype) would have been at least one a length."""
    _, ranks, _, _ = runs
    for res in ranks["sched"]:
        assert res["staged_equal"].tolist() == [True] * len(STAGED_LENGTHS)
        bufs = res["host_buffers"].tolist()
        assert len(bufs) == len(set(map(tuple, bufs))) > 0
        for size in {s for _, s in bufs}:
            caps = [c for c, s in bufs if s == size]
            assert all(c & (c - 1) == 0 for c in caps)
            assert len(caps) <= max(caps).bit_length()
        assert len(bufs) < len(STAGED_LENGTHS)


def test_disaggregated_scheduler_over_model_ranks_matches_jax(runs):
    """Over data 1 x model 2 the disaggregated scheduler preempts, and
    every request's tokens are the JAX ``DisaggregatedScheduler``'s on the
    ``(1, 2)`` mesh and the colocated scheduler's over the same ranks;
    both ranks hold the same tokens, prefills, decode steps, evictions
    and decode shapes as the one-rank disaggregated run."""
    want, ranks, _, one = runs
    jax_tokens = {int(k): v for k, v in want["disagg_tokens"].items()}
    assert want["disagg_evictions"] > 0 and one.blocks.evictions > 0
    assert jax_tokens == {int(k): v for k, v in want["tokens"].items()}
    for res in ranks["sched"]:
        assert _tokens(res, "disagg/") == jax_tokens == _tokens(res)
        assert res["disagg/counts"].tolist() == [
            one.n_prefills, one.n_decode_steps, one.blocks.evictions]
        assert sorted(map(tuple, res["disagg/shapes"].tolist())) == \
            sorted(one.decode_shapes_compiled)


def test_disaggregated_ranks_ship_half_the_one_rank_bytes(runs):
    """Each rank ships its own KV heads: the same inserts, blocks and
    messages as the one-rank run, and half its payload bytes."""
    _, ranks, _, one = runs
    st = one.connector.stats
    for res in ranks["sched"]:
        requests, blocks, payload, messages, _ = \
            res["disagg/stats"].tolist()
        assert (requests, blocks, messages) == (st.requests, st.blocks,
                                                st.messages)
        assert 2 * payload == st.payload_bytes > 0


def test_bit_flip_on_one_rank_changes_the_disaggregated_tokens(runs):
    """A connector that flips the top exponent bit of request 0's first V
    element on rank 1 alone: both ranks still agree (the pick is the
    gathered one), and request 0's tokens part from the colocated
    run's."""
    _, ranks, _, _ = runs
    flipped = [_tokens(res, "flip/")[0] for res in ranks["sched"]]
    assert flipped[0] == flipped[1]
    assert flipped[0] != _tokens(ranks["sched"][0])[0]
