"""Rank worlds of the port on the CPU for its tests: ``spawn`` starts n
processes over gloo, each with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), a ``file://``
rendezvous in the test's own directory (parallel test workers never share
a TCP port), one torch thread and a timeout of its own, and runs one of
this module's workers in each.  The workers import torch, numpy and the
port only; each writes its results to ``out/rank<r>.npz`` (r the torch
rank; rank 0 also ``out/gathered``, a checkpoint of the gathered state).
A ``model`` keyword lays the ranks out as dp x model, model minor, a
``shard_axis`` one makes the pods of FSDP within a pod."""

import contextlib
import json
import os
import subprocess
import sys

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(TESTS), "src")
TIMEOUT = 120


def spawn(worker: str, n: int, out: str, timeout: int = TIMEOUT, **kw):
    """Run ``worker(world, out, **kw)`` on ``n`` gloo ranks; fails the test
    if any rank exits non-zero or outlives ``timeout`` seconds."""
    os.makedirs(out, exist_ok=True)
    init = "file://" + os.path.join(out, "rendezvous")
    script = (f"import sys; sys.path[:0] = [{SRC!r}, {TESTS!r}]; "
              f"import json, rank_runs; rank_runs.run({worker!r}, "
              f"json.loads(sys.argv[1]))")
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   OMP_NUM_THREADS="1", REPRO_TEST_INIT=init)
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script,
             json.dumps(dict(kw, out=out))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env))
    logs, failed = [], []
    for r, p in enumerate(procs):
        try:
            log, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            log = p.communicate()[0]
            failed.append(f"rank {r} timed out after {timeout} s")
        logs.append(log)
        if p.returncode:
            failed.append(f"rank {r} exited {p.returncode}")
    assert not failed, f"{failed}\n" + "\n".join(
        f"--- rank {r} ---\n{log[-3000:]}" for r, log in enumerate(logs))
    return [dict(np.load(os.path.join(out, f"rank{r}.npz")))
            for r in range(n)]


def run(worker: str, kw: dict) -> None:
    import torch
    from repro_torch.launch import mesh
    torch.set_num_threads(1)
    world = mesh.init_rank_world(kw.pop("data"), kw.pop("pod", None),
                                 model=kw.pop("model", 1),
                                 device_type="cpu",
                                 init_method=os.environ["REPRO_TEST_INIT"],
                                 shard_axis=kw.pop("shard_axis", None))
    try:
        results = WORKERS[worker](world, **kw)
        np.savez(os.path.join(kw["out"], f"rank{world.torch_rank}.npz"),
                 **results)
    finally:
        mesh.shutdown()


# ---------------------------------------------------------------------------
# Workers
# ---------------------------------------------------------------------------

def tree_inputs(leaves: dict, bf16, P: int, seed: int = 0):
    """The global ``(P, ...)`` float32 arrays of a test tree; leaves named
    in ``bf16`` are bfloat16 in the torch tree."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal((P,) + tuple(shape)).astype(np.float32)
            for k, shape in leaves.items()}


def torch_tree(arrs: dict, bf16, rows=slice(None)):
    import torch
    return {k: torch.from_numpy(a[rows]).to(
        torch.bfloat16 if k in bf16 else torch.float32)
        for k, a in arrs.items()}


def _save_tree(results: dict, prefix: str, tree) -> None:
    for k, v in tree.items():
        results[f"{prefix}/{k}"] = v.float().numpy()


def plan_worker(world, out, leaves, bf16, variants, group_sizes,
                hierarchical=False):
    """This rank's row of ``tree_inputs`` through every plan variant on
    every phase offset (``average``), ``sync`` and the wire's ``pmean``,
    and through each baseline's ``comm`` on each phase and its ``sync``.
    Overlapped variants also record the wire's event log of each average
    (``events/<S>/<variant>/<offset>``, JSON) and run each offset again
    with mispaired receipts planted (``fault/<S>/<variant>/<offset>``);
    ``slots/<S>`` the wire's slots after the group averages at S."""
    import json
    import torch
    from repro_torch.core import baselines, overlap
    from repro_torch.core import plan as plan_mod
    from repro_torch.core import tree as tr
    arrs = tree_inputs(leaves, bf16, world.P)
    rows = slice(world.rank, world.rank + 1)
    tree = torch_tree(arrs, bf16, rows)
    topo = (plan_mod.Topology.hierarchical(world.axis_names,
                                           world.axis_sizes)
            if hierarchical else
            plan_mod.Topology.flat(world.axis_names, world.axis_sizes))
    wire = plan_mod.wire_for(world)
    res = {}
    for S in group_sizes:
        for name, cfg_kw in variants.items():
            cfg = plan_mod.AveragingConfig(group_size=S, **cfg_kw)
            plan = plan_mod.compile_plan(topo, tr.struct(tree, drop=1), cfg,
                                         world=world)
            logged = cfg.fused and cfg.overlap
            for off in plan.offsets:
                wire.events = [] if logged else None
                _save_tree(res, f"avg/{S}/{name}/{off}",
                           plan.average_offset(tree, off))
                if logged:
                    res[f"events/{S}/{name}/{off}"] = np.asarray(
                        json.dumps(wire.events))
                    with planted("mispaired_receipts"):
                        _save_tree(res, f"fault/{S}/{name}/{off}",
                                   plan.average_offset(tree, off))
                wire.events = None
            _save_tree(res, f"sync/{S}/{name}", plan.sync(tree))
        res[f"slots/{S}"] = np.asarray(wire.n_slots)
    res["pmean"] = overlap.resolve(wire.pmean_rows(
        tree["w"].float())).numpy()
    for name in baselines.BASELINES:
        av = baselines.make_averager(name, world.axis_names,
                                     world.axis_sizes, topology=topo,
                                     world=world)
        for phase in range(av.n_phases):
            _save_tree(res, f"{name}/comm/{phase}", av.comm(tree, phase))
        _save_tree(res, f"{name}/sync", av.sync(tree))
    return res


def smoke_cfg(arch, dtype="float32", n_layers=None):
    """The smoke config of ``arch`` in ``dtype``, at ``n_layers`` where
    given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch, smoke=True).variant(dtype=dtype)
    return cfg.variant(n_layers=n_layers) if n_layers else cfg


def _rank_trainer(world, arch, init, trainer_kw, pod_dcn, dtype,
                  n_layers=None):
    """The port's ``Trainer`` on this rank, warm-started from the
    checkpoint ``init`` (the ``(P, ...)`` state; ``pod_dcn``: on the
    hierarchical topology)."""
    from repro_torch.checkpoint import load_replica_state
    from repro_torch.core.plan import Topology
    from repro_torch.launch.train import Trainer
    cfg = smoke_cfg(arch, dtype, n_layers)
    data, pod = world_axes(world)
    state = load_replica_state(init, state_template(cfg, world.P,
                                                    trainer_kw))
    topology = (Topology.hierarchical(world.axis_names, world.axis_sizes)
                if pod_dcn else None)
    return Trainer(cfg, data, pod_axis=pod, world=world, init_state=state,
                   topology=topology, **trainer_kw)


def trainer_worker(world, out, arch, init, trainer_kw, steps,
                   pod_dcn=False, dtype="float32"):
    """:func:`_rank_trainer` for ``steps`` steps; rank 0 writes the
    gathered final state to ``out/gathered``."""
    trainer = _rank_trainer(world, arch, init, trainer_kw, pod_dcn, dtype)
    losses = [trainer.step_once(t) for t in range(steps)]
    trainer.save_checkpoint(os.path.join(out, "gathered"))
    return {"losses": np.asarray(losses),
            "skipped": np.asarray(trainer.skipped_nonfinite),
            "step_phase": np.asarray([trainer.state.step,
                                      trainer.state.phase])}


def consolidated_worker(world, out, arch, init, trainer_kw, steps,
                        pod_dcn=False, dtype="float32"):
    """:func:`_rank_trainer` for ``steps`` steps, then
    ``Trainer.consolidated()``: ``is_none`` and, where it is not None
    (rank 0), its leaves as ``cons/<key path>``."""
    trainer = _rank_trainer(world, arch, init, trainer_kw, pod_dcn, dtype)
    for t in range(steps):
        trainer.step_once(t)
    cons = trainer.consolidated()
    res = {"is_none": np.asarray(cons is None)}
    if cons is not None:
        _save_tree(res, "cons", flat_tree(cons))
    return res


@contextlib.contextmanager
def planted(fault):
    """A planted model-axis fault, on every rank alike (so that the
    collectives still pair): ``"no_f_backward"`` runs every
    ``copy_to_model`` as the plain identity (no all-reduce of its
    gradient), ``"q_norm_unsummed"`` only ``q_norm``'s and
    ``"w_r_unsummed"`` only the RG-LRU gate kernel ``w_r``'s;
    ``"enc_out_unsummed"`` leaves out the one on the encoder output that
    the cross-attention reads; ``"local_pick"`` makes the paged steps pick
    the greedy token among the rank's own vocab columns;
    ``"router_gather_summed"`` gives the MoE router's logits the gather
    whose gradient sums over the ranks, ``"gate_unsummed"`` leaves out the
    MoE gates' ``copy_to_model`` and ``"wif_unsummed"`` the mLSTM's
    ``wif``'s; ``"mispaired_receipts"`` makes the wavefront's combine of
    bucket k read bucket k+1's receipt (:func:`mispaired_take`)."""
    from repro_torch.core import overlap
    from repro_torch.models import common as cm
    from repro_torch.models import encdec, moe, rglru, xlstm
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import kv_cache
    copy, qkv, gates = cm.copy_to_model, tfm._qkv, rglru._gates
    take = overlap.take_receipt
    cross, pick = encdec._cross_input, kv_cache.greedy_pick
    gather, topk = cm.gather_replicated_from_model, moe.router_topk
    preacts = xlstm._mlstm_preacts
    seen = {}
    if fault == "no_f_backward":
        cm.copy_to_model = lambda x, mw: x
    elif fault == "q_norm_unsummed":
        def qkv_noting(cfg, p, h, mw=None):
            seen["leaf"] = p.get("q_norm")
            return qkv(cfg, p, h, mw)
        tfm._qkv = qkv_noting
    elif fault == "w_r_unsummed":
        def gates_noting(p, u, mw=None):
            seen["leaf"] = p["w_r"]
            return gates(p, u, mw)
        rglru._gates = gates_noting
    elif fault == "enc_out_unsummed":
        encdec._cross_input = lambda cfg, enc_out, mw=None: enc_out
    elif fault == "local_pick":
        kv_cache.greedy_pick = local_pick
    elif fault == "router_gather_summed":
        cm.gather_replicated_from_model = cm.gather_from_model
    elif fault == "gate_unsummed":
        def topk_noting(cfg, logits):
            idx, gate, aux = topk(cfg, logits)
            seen["leaf"] = gate
            return idx, gate, aux
        moe.router_topk = topk_noting
    elif fault == "wif_unsummed":
        def preacts_noting(cfg, p, x, mw=None):
            seen["leaf"] = p["wif"]
            return preacts(cfg, p, x, mw)
        xlstm._mlstm_preacts = preacts_noting
    elif fault == "mispaired_receipts":
        overlap.take_receipt = mispaired_take
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    if "unsummed" in (fault or "") and fault != "enc_out_unsummed":
        cm.copy_to_model = lambda x, mw: (x if x is seen.get("leaf")
                                          else copy(x, mw))
    try:
        yield
    finally:
        cm.copy_to_model, tfm._qkv, rglru._gates = copy, qkv, gates
        encdec._cross_input, kv_cache.greedy_pick = cross, pick
        cm.gather_replicated_from_model, moe.router_topk = gather, topk
        xlstm._mlstm_preacts = preacts
        overlap.take_receipt = take


def mispaired_take(inflight, k):
    """The receipt the wavefront must not hand bucket k's combine: bucket
    k+1's, where it is in flight, read into bucket k's delivery as far as
    both reach."""
    from repro_torch.core import overlap
    own = overlap.resolve(inflight.pop(k))
    if k + 1 not in inflight:
        return own
    other = overlap.resolve(inflight[k + 1]).reshape(-1)
    wrong = own.clone()
    n = min(own.numel(), other.numel())
    wrong.view(-1)[:n] = other[:n]
    return wrong


def local_pick(model, last):
    """The greedy pick the paged steps must not make over a model world:
    the argmax of the rank's own masked vocab columns, numbered from the
    rank's first, and the rank's logits."""
    import torch
    from repro_torch.models import common as cm
    n = last.shape[-1]
    lo = model.model_world.rank * n if model.model_world else 0
    cols = lo + torch.arange(n, device=last.device)
    last = torch.where(cols < model.cfg.vocab, last, cm.NEG_INF)
    return last.argmax(-1), last


def _states_equal(a, b) -> bool:
    from repro_torch.core import tree as tr
    import torch
    return all(torch.equal(x, y) for x, y in zip(
        tr.tree_leaves((a.params, a.opt_state)),
        tr.tree_leaves((b.params, b.opt_state))))


def model_axis_worker(world, out, runs, serve=None, serves=None):
    """Each of ``runs`` (name -> arch, init, trainer_kw, steps, fault and
    optionally n_layers) for its steps on this rank's slices; rank 0
    writes the gathered state to ``out/<name>``, which every rank then
    restores into a new ``Trainer`` (``<name>/restored``: bit for bit).
    Then ``serve`` (:func:`serve_greedy`'s spec; ``serve/logits`` the
    gathered logits of the prefill and each step, ``serve/tokens``) and
    each of ``serves`` (name -> spec, as ``<name>/serve/...``)."""
    import torch
    from repro_torch.checkpoint import load_replica_state
    from repro_torch.launch.train import Trainer
    from repro_torch.models import common as cm
    res = {}
    for name, r in runs.items():
        with planted(r.get("fault")):
            trainer = _rank_trainer(world, r["arch"], r["init"],
                                    r["trainer_kw"], False, "float32",
                                    r.get("n_layers"))
            res[f"{name}/losses"] = np.asarray(
                [trainer.step_once(t) for t in range(r["steps"])])
            res[f"{name}/skipped"] = np.asarray(trainer.skipped_nonfinite)
            res[f"{name}/step_phase"] = np.asarray([trainer.state.step,
                                                    trainer.state.phase])
        path = os.path.join(out, name)
        trainer.save_checkpoint(path)
        cfg = smoke_cfg(r["arch"], n_layers=r.get("n_layers"))
        data, pod = world_axes(world)
        again = Trainer(cfg, data, pod_axis=pod, world=world,
                        init_state=load_replica_state(
                            path, state_template(cfg, world.P,
                                                 r["trainer_kw"])),
                        **r["trainer_kw"])
        res[f"{name}/restored"] = np.asarray(_states_equal(trainer.state,
                                                           again.state))
        # the leaves held whole: bit-identical over the model group
        whole = cm.held_whole(trainer.state.params, cm.placement(
            cfg, trainer.state.params, world.model))
        res[f"{name}/whole"] = torch.cat([a.reshape(-1) for a in whole]
                                         ).numpy()
    named = dict(serves or {})
    if serve is not None:
        named[""] = serve
    for name, spec in named.items():
        logits, tokens = serve_greedy(world, spec)
        prefix = f"{name}/" if name else ""
        res[f"{prefix}serve/logits"] = logits
        res[f"{prefix}serve/tokens"] = tokens
    return res


def serve_greedy(world, serve):
    """``serve`` (arch, params, prompts, max_len, steps, optionally
    n_layers and ``extra``, an npz of the encoder's or the prefix's inputs
    of every row): this dp rank's rows through ``build_prefill`` and
    ``build_serve_step`` on its slices (over the world's dp ranks, each
    routing its own rows); returns the gathered logits of the
    prefill and each step (B, steps + 1, V) and the greedy tokens.  A
    vlm's decode positions count its patches."""
    import torch
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.models import common as cm
    from repro_torch.models.registry import build_model
    from repro_torch.serve.decode import build_prefill, build_serve_step
    cfg = smoke_cfg(serve["arch"], n_layers=serve.get("n_layers"))
    model = build_model(cfg, "cpu", model_world=world.model_world)
    mw = world.model_world
    whole, _ = load_checkpoint(serve["params"], _spec_tree(cfg))
    params = cm.take_slices(whole, cm.placement(cfg, whole, world.model), mw)
    prompts = np.load(serve["prompts"])
    rows = prompts.shape[0] // world.P
    mine = slice(world.rank * rows, (world.rank + 1) * rows)
    batch = {"tokens": torch.from_numpy(prompts[mine])}
    if serve.get("extra"):
        batch.update({k: torch.from_numpy(v[mine])
                      for k, v in np.load(serve["extra"]).items()})
    logits, caches = build_prefill(model, serve["max_len"], world.P)(
        params, batch)
    step = build_serve_step(model, world.P)
    masked = torch.where(torch.arange(logits.shape[-1]) < cfg.vocab, logits,
                         cm.NEG_INF)
    tok = masked[:, -1].argmax(-1)[:, None]
    pos0 = prompts.shape[1] + (cfg.n_patches if cfg.family == "vlm" else 0)
    all_logits, all_tokens = [logits[:, -1]], [tok[:, 0]]
    for i in range(serve["steps"]):
        tok, logits, caches = step(params, caches, tok, pos0 + i)
        all_logits.append(logits[:, -1])
        all_tokens.append(tok[:, 0])
    return (torch.stack(all_logits, 1).numpy(),
            torch.stack(all_tokens, 1).numpy())


def scheduler_worker(world, out, arch, params, prompts, new, sched_kw,
                     fault=None, staged_lengths=(), disagg=False):
    """The paged ``ServeScheduler`` on this rank's slices (``fault`` planted
    on every rank alike): every prompt of ``prompts`` (an npz of 1-D
    arrays keyed by request id, submitted in order, ``new[id]`` tokens
    each) from the
    checkpoint ``params``; returns each request's tokens
    (``tokens/<key>``), the admission and eviction counts, the decode
    shapes.  Then, over the same group with host staging
    (``ModelWorld.staged``), one prefill at each of ``staged_lengths``
    against the same prefill unstaged (``staged_equal``: bit for bit) and
    the pinned buffers it left (``host_buffers``: capacity and element
    size of each).  With ``disagg``, the same requests through the
    ``DisaggregatedScheduler`` (``disagg/...``: tokens, counts, shapes and
    the rank's ``TransferStats``), then request 0 alone through it with
    rank 1's connector flipping the top exponent bit of its first V
    element (``flip/tokens/0``)."""
    import dataclasses
    import torch
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core import tree as tr
    from repro_torch.models import common as cm
    from repro_torch.models.registry import build_model
    from repro_torch.serve.decode import build_prefill
    from repro_torch.serve.kv_transfer import DisaggregatedScheduler
    from repro_torch.serve.scheduler import Request, ServeScheduler
    cfg = smoke_cfg(arch)
    mw = world.model_world
    model = build_model(cfg, "cpu", model_world=mw)
    whole, _ = load_checkpoint(params, _spec_tree(cfg))
    params = cm.take_slices(whole, cm.placement(cfg, whole, world.model), mw)
    reqs = np.load(prompts)
    res = {}
    with planted(fault):
        sched = ServeScheduler(model, params, **sched_kw)
        for k in sorted(reqs, key=int):
            sched.submit(Request(int(k), reqs[k], new[int(k)]))
        outs = sched.run()
    for rid, toks in outs.items():
        res[f"tokens/{rid}"] = np.asarray(toks)
    res["counts"] = np.asarray([sched.n_prefills, sched.n_decode_steps,
                                sched.blocks.evictions])
    res["shapes"] = np.asarray(sorted(sched.decode_shapes_compiled))
    if disagg:
        prefill_params = tr.tree_map(torch.clone, params)
        for name, rids, conn in (
                ("disagg", sorted(reqs, key=int), None),
                ("flip", sorted(reqs, key=int)[:1],
                 flipping_connector() if world.model_rank == 1 else None)):
            d = DisaggregatedScheduler(model, params,
                                       prefill_params=prefill_params,
                                       connector=conn, **sched_kw)
            for k in rids:
                d.submit(Request(int(k), reqs[k], new[int(k)]))
            for rid, toks in d.run().items():
                res[f"{name}/tokens/{rid}"] = np.asarray(toks)
            if name == "disagg":
                res["disagg/counts"] = np.asarray([
                    d.n_prefills, d.n_decode_steps, d.blocks.evictions])
                res["disagg/shapes"] = np.asarray(
                    sorted(d.decode_shapes_compiled))
                res["disagg/stats"] = np.asarray(
                    list(dataclasses.astuple(d.connector.stats)))
    if staged_lengths:
        cm._HOST.clear()
        staged = build_model(cfg, "cpu", model_world=dataclasses.replace(
            mw, staged=True))
        equal = []
        for n in staged_lengths:
            batch = {"tokens": torch.from_numpy(
                np.resize(reqs[sorted(reqs, key=int)[0]], n)[None])}
            got = build_prefill(staged, n)(params, batch)
            want = build_prefill(model, n)(params, batch)
            equal.append(all(torch.equal(a, b) for a, b in zip(
                [got[0]] + [c for g in got[1].values() for c in g.values()],
                [want[0]] + [c for g in want[1].values()
                             for c in g.values()])))
        res["staged_equal"] = np.asarray(equal)
        res["host_buffers"] = np.asarray(
            [[cap, torch.empty((), dtype=dt).element_size()]
             for cap, dt in cm._HOST])
    return res


def flipping_connector():
    """A connector that flips the top exponent bit of the first V element
    (layer 0, block 0, position 0, KV head 0, dim 0) of the first request
    it ships, as it packs it for the wire: handoff check (d)'s fault."""
    import torch
    from repro_torch.serve import LinkCostedConnector

    class Flip(LinkCostedConnector):
        def insert(self, rid, kv_blocks, meta):
            if self.stats.requests == 0:
                v = kv_blocks["global"]["v"]
                bits = 8 * v.element_size()
                ints = v.view({16: torch.int16, 32: torch.int32}[bits])
                ints.view(-1)[0] ^= 1 << (bits - 2)
            super().insert(rid, kv_blocks, meta)

    return Flip()


def routed_count_worker(world, out, arch):
    """A prefill of two rows of 8 tokens on this rank's slices of the
    rank-sliced init from seed 2: the gathered last logits and the
    ``routed`` all-reduces it made (``common.tp_stats``)."""
    import torch
    from repro_torch.models import common as cm
    from repro_torch.models.registry import build_model
    from repro_torch.serve.decode import build_prefill
    cfg = smoke_cfg(arch)
    model = build_model(cfg, "cpu", model_world=world.model_world)
    params = model.init(torch.Generator().manual_seed(2))
    tokens = torch.from_numpy(np.arange(16).reshape(2, 8) % cfg.vocab)
    before = cm.tp_stats()["routed"]
    logits, _ = build_prefill(model, 8)(params, {"tokens": tokens})
    return {"logits": logits.numpy(),
            "routed": np.asarray(cm.tp_stats()["routed"] - before)}


def loss_grads_worker(world, out, arch, variant):
    """The loss of one batch (4 rows of 16 tokens from numpy seed 0) and
    its gradient on this rank's slices of the rank-sliced init from seed
    3, ``arch``'s smoke config in float32 with ``variant``; the gradient
    by leaf path (``grad/<path>``)."""
    import torch
    from repro_torch.core import tree as tr
    from repro_torch.models import common as cm
    from repro_torch.models.registry import build_model
    cfg = smoke_cfg(arch).variant(**variant)
    model = build_model(cfg, "cpu", model_world=world.model_world)
    params = model.init(torch.Generator().manual_seed(3))
    leaves = tr.tree_leaves(params)
    for a in leaves:
        a.requires_grad_(True)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (4, 17))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1]),
             "labels": torch.from_numpy(tokens[:, 1:])}
    loss, _ = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    paths = []
    cm.map_with_path(lambda p, a: paths.append(p), params)
    return dict({"loss": loss.detach().numpy()},
                **{f"grad/{p}": g.numpy() for p, g in zip(paths, grads)})


# ---------------------------------------------------------------------------
# FSDP within a pod over ranks (gather-all)
# ---------------------------------------------------------------------------

def fsdp_topology(name: str, sizes, budget=None):
    """The ("data", "pod") topology of the FSDP tests (the port's twin of
    ``tests/test_torch_fsdp.py``'s): one link class, or ICI data and DCN
    pod, each pinned to ``budget`` bytes (the cost model's where None)."""
    from repro_torch.core import plan as plan_mod
    if name == "flat":
        return plan_mod.Topology(("data", "pod"), tuple(sizes), (
            plan_mod.LinkClass("link", bucket_bytes=budget),), (0, 0))
    return plan_mod.Topology(("data", "pod"), tuple(sizes), (
        plan_mod.LinkClass("ici", alpha=1e-6, beta=1e-11,
                           bucket_bytes=budget),
        plan_mod.LinkClass("dcn", alpha=5e-5, beta=1e-10,
                           bucket_bytes=budget)), (0, 1))


def fsdp_plan_checks(world, tree, inputs, res, prefix):
    """The sharded plan over ``world`` (its pods of FSDP within a pod) on
    ``inputs`` (``pods/<k>``: the ``(P_eff, ...)`` pod trees; ``grads/<k>``
    the ``(P, ...)`` member gradients; ``wire``: a ``(P, m)`` float32
    row a rank): ``shard_tree``, ``unshard_tree``, ``grad_shards``,
    ``_average_sharded`` on every offset, flat and hierarchical,
    overlapped and serial, ``sync``, the pod wire's ``ring_shift`` and
    ``pmean_rows``, and ``grad_shards`` again with the members' slices
    added in reverse order (``reversed_sum``), into ``res`` under
    ``prefix``."""
    import torch
    from repro_torch.core import overlap
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.replica import ShardingPolicy
    from repro_torch.core import tree as tr
    fsdp = ShardingPolicy.fsdp_within_pod("data")
    specs = {k: tr.Spec(tuple(sh), getattr(torch, d))
             for k, (sh, d) in tree.items()}
    pod = world.pod_of("data")
    mine = lambda key, row: {k: torch.from_numpy(
        inputs[f"{key}/{k}"][row:row + 1]).to(specs[k].dtype) for k in tree}
    grads = {k: v[0] for k, v in mine("grads", world.rank).items()}
    for topo in ("flat", "hier"):
        for mode in ("overlap", "serial"):
            plan = plan_mod.compile_plan(
                fsdp_topology(topo, world.axis_sizes, 4096), specs,
                plan_mod.AveragingConfig(group_size=2,
                                         overlap=mode == "overlap"),
                fsdp, world)
            shards = plan.shard_tree(mine("pods", pod))
            key = f"{prefix}/{topo}/{mode}"
            for b, x in enumerate(shards):
                res[f"{key}/shard/{b}"] = x.float().numpy()
            for off in plan.offsets:
                for b, x in enumerate(plan._average_sharded(shards, off)):
                    res[f"{key}/avg/{off}/{b}"] = x.float().numpy()
            if mode == "serial":
                continue
            _save_tree(res, f"{key}/unshard", plan.unshard_tree(shards))
            for b, x in enumerate(plan.grad_shards(iter([grads]))):
                res[f"{key}/grads/{b}"] = x.numpy()
            for b, x in enumerate(plan.sync(shards)):
                res[f"{key}/sync/{b}"] = x.float().numpy()
            with reversed_sum():
                for b, x in enumerate(plan.grad_shards(iter([grads]))):
                    res[f"{key}/reversed/{b}"] = x.numpy()
    row = torch.from_numpy(inputs["wire"][world.rank:world.rank + 1])
    res[f"{prefix}/ring"] = overlap.resolve(plan.wire.ring_shift(
        row, 1, plan.eff_topology.axis_sizes[0])).numpy()
    res[f"{prefix}/pmean"] = overlap.resolve(plan.wire.pmean_rows(
        row)).numpy()


@contextlib.contextmanager
def reversed_sum():
    """The planted fault of the rank-order sums: ``plan._sum_rows`` adds
    the rows from the last to the first."""
    from repro_torch.core import plan as plan_mod
    real = plan_mod._sum_rows
    plan_mod._sum_rows = lambda rows: real(rows.flip(0))
    try:
        yield
    finally:
        plan_mod._sum_rows = real


def fsdp_state_template(cfg, plan):
    """A ``(P_eff, n_b)`` FSDP ReplicaState of Specs of ``plan`` (SGD)."""
    import torch
    from repro_torch.core import replica
    from repro_torch.optim.sgd import SGDState
    return replica.sharded_state_template(
        plan, SGDState(None, torch.zeros(1, dtype=torch.int32)))


def fsdp_trainer(world, arch, init, trainer_kw, seq_len, global_batch,
                 streamed=False, budget=None):
    """The port's FSDP ``Trainer`` over ``world`` (gather-all, or
    layer-streamed) on the hierarchical topology (each link class's
    budget pinned to ``budget`` bytes where given), warm-started from the
    model-1 FSDP checkpoint ``init`` (either layout: a restore across them
    goes through the canonical tree)."""
    from repro_torch.checkpoint import load_replica_state
    from repro_torch.core.plan import Topology
    from repro_torch.launch.train import Trainer
    cfg = smoke_cfg(arch)
    data, pod = world_axes(world)
    topology = (Topology.hierarchical(world.axis_names, world.axis_sizes,
                                      dcn_axes=("pod",))
                if budget is None else fsdp_topology(
                    "hier", world.axis_sizes, budget))
    kw = dict(trainer_kw, seq_len=seq_len, global_batch=global_batch,
              seed=0, sharding="fsdp", streamed=streamed, topology=topology)
    trainer = Trainer(cfg, data, pod_axis=pod, world=world, **kw)
    state = load_replica_state(init, fsdp_state_template(
        cfg, trainer.whole_plan()), sharding=trainer.sharding,
        plan=trainer.whole_plan(), layered=trainer.model.layered)
    trainer.state = trainer._put_state(state)
    return trainer


def poisoned_step(trainer, world, bad: int, how: str):
    """Step 0 with member ``bad``'s batch poisoned: ``"mask"`` makes its
    rows' loss mask NaN, ``"element"`` its gradient's first element (in
    the first bucket's first slice: one member's slice alone)."""
    import torch
    from repro_torch.core import tree as tr
    from repro_torch.train import train_step
    batch = trainer._put_batch(0)
    real = train_step.value_and_grad
    if how == "mask":
        batch["mask"] = torch.full_like(
            batch["labels"], float("nan") if world.rank == bad else 1.0,
            dtype=torch.float32)
    elif world.rank == bad:
        def poisoned(model, params, b):
            grads, metrics = real(model, params, b)
            tr.tree_leaves(grads)[0].view(-1)[0] = float("nan")
            return grads, metrics
        train_step.value_and_grad = poisoned
    try:
        trainer.state, metrics = trainer._step_fn(0)(trainer.state, batch)
    finally:
        train_step.value_and_grad = real
    return float(metrics["skipped_nonfinite"])


def fsdp_ranks_worker(world, out, tree, inputs, arch, inits, runs, seq_len,
                      global_batch, steps, bad):
    """All rank checks of gather-all FSDP over ranks in one world: the
    plan checks (:func:`fsdp_plan_checks`) over this world (data 2 x pod
    4) and over data 4 x pod 2 on the same ranks; then each of ``runs``
    (name -> averager and Trainer kwargs) for ``steps`` steps from the
    checkpoint ``inits[name]``, rank 0 writing the gathered state to
    ``out/<name>``; then one step poisoned at member ``bad`` (its mask
    rows, ``out/guard``; one element of its gradient, ``out/element``),
    and the element again under a guard without the MIN over the pod
    (``out/no_min``)."""
    from repro_torch.launch import mesh
    from repro_torch.train import train_step
    inputs = dict(np.load(inputs))
    res = {}
    fsdp_plan_checks(world, tree, {k[len("2x4/"):]: v for k, v in
                                   inputs.items() if k.startswith("2x4/")},
                     res, "2x4")
    other = mesh.init_rank_world(4, 2, device_type="cpu",
                                 shard_axis="data")
    fsdp_plan_checks(other, tree, {k[len("4x2/"):]: v for k, v in
                                   inputs.items() if k.startswith("4x2/")},
                     res, "4x2")
    for name, kw in runs.items():
        trainer = fsdp_trainer(world, arch, inits[name], kw, seq_len,
                               global_batch)
        res[f"{name}/losses"] = np.asarray(
            [trainer.step_once(t) for t in range(steps)])
        res[f"{name}/skipped"] = np.asarray(trainer.skipped_nonfinite)
        cons = trainer.consolidated()
        res[f"{name}/consolidated"] = np.asarray(cons is None)
        if cons is not None:
            _save_tree(res, f"{name}/cons", flat_tree(cons))
        trainer.save_checkpoint(os.path.join(out, name))
    for name, how, guard in (("guard", "mask", None),
                             ("element", "element", None),
                             ("no_min", "element", lambda plan, f: f)):
        real = train_step.pod_all_finite
        if guard is not None:
            train_step.pod_all_finite = guard
        try:
            trainer = fsdp_trainer(world, arch, inits["wagma"],
                                   runs["wagma"], seq_len, global_batch)
            res[f"{name}/skipped"] = np.asarray(
                poisoned_step(trainer, world, bad, how))
        finally:
            train_step.pod_all_finite = real
        res[f"{name}/count"] = trainer.state.opt_state.count.numpy()
        trainer.save_checkpoint(os.path.join(out, name))
    return res


# ---------------------------------------------------------------------------
# Layer-streamed FSDP within a pod over ranks
# ---------------------------------------------------------------------------

def streamed_plan(sizes, budget, world=None):
    """The streamed plan of the smoke tinyllama-1.1b's layered tree on the
    ``(data, pod)`` ``sizes``, hierarchical, each class's budget pinned to
    ``budget`` bytes; over ``world`` where given, else one process."""
    from repro_torch.core import plan as plan_mod
    from repro_torch.core.replica import ShardingPolicy
    from repro_torch.models.registry import build_model
    cfg = smoke_cfg("tinyllama-1.1b")
    specs = build_model(cfg, "cpu").layered.split(_spec_tree(cfg))
    return plan_mod.compile_plan(
        fsdp_topology("hier", sizes, budget), specs,
        plan_mod.AveragingConfig(group_size=2),
        ShardingPolicy.fsdp_within_pod("data", streamed=True), world)


def streamed_inputs(plan, seed: int = 0):
    """The streamed plan checks' numpy inputs, made from ``seed``: the
    pods' layered trees ``(P_eff, ...)`` and every member's gradient
    ``(P, ...)``, as lists of float32 leaves in the plan's leaf order."""
    from repro_torch.core import tree as tr
    rng = np.random.default_rng(seed)
    leaves = [tuple(s.shape) for s in tr.tree_leaves(plan.storage_struct)]
    pods = [rng.standard_normal((plan.P_eff,) + s).astype(np.float32)
            for s in leaves]
    grads = [rng.standard_normal((plan.P,) + s).astype(np.float32)
             for s in leaves]
    return pods, grads


def group_tree(plan, leaves, g):
    """Group ``g``'s sub-tree of a layered tree given as its leaves."""
    from repro_torch.core import streaming
    from repro_torch.core import tree as tr
    treedef = tr.tree_flatten(plan.storage_struct)[1]
    tree = tr.tree_unflatten(treedef, list(leaves))
    if g == streaming.STEM_GROUP:
        return tree["stem"]
    if g == streaming.head_group(plan.n_stream_spans):
        return tree["head"]
    return tree["layers"][g - 1]


def streamed_plan_checks(world, budget, res, prefix):
    """The streamed plan over ``world`` on :func:`streamed_inputs`: its
    pod's row sliced by ``shard_tree``, every group's ``stream_unshard``
    (resolved) and ``stream_grad_shards`` of this member's gradients
    (resolved), into ``res`` under ``prefix``."""
    import torch
    from repro_torch.core import overlap
    from repro_torch.core import tree as tr
    plan = streamed_plan(world.axis_sizes, budget, world)
    pods, grads = streamed_inputs(plan)
    pod = world.pod_of("data")
    treedef = tr.tree_flatten(plan.storage_struct)[1]
    shards = plan.shard_tree(tr.tree_unflatten(treedef, [
        torch.from_numpy(a[pod:pod + 1]) for a in pods]))
    mine = [torch.from_numpy(a[world.rank]) for a in grads]
    for g in sorted(set(plan.shard_layout.bucket_groups)):
        tree = overlap.resolve(plan.stream_unshard(shards, g, pod=pod))
        for i, leaf in enumerate(tr.tree_leaves(tree)):
            res[f"{prefix}/unshard/{g}/{i}"] = leaf.numpy()
        out = overlap.resolve(plan.stream_grad_shards(
            iter([group_tree(plan, mine, g)]), g))
        for b, x in enumerate(out):
            res[f"{prefix}/grads/{g}/{b}"] = x.numpy()


def mispaired_gathered(gathered, g):
    """The gather the engine must not hand group ``g``'s compute: group
    g+1's, where it is in flight and has the same shapes (span k+1's, at
    span k's forward)."""
    from repro_torch.core import overlap
    from repro_torch.core import tree as tr
    own = overlap.resolve(gathered.pop(g))
    if g + 1 not in gathered:
        return own
    other = overlap.resolve(gathered[g + 1])
    shapes = lambda t: [tuple(l.shape) for l in tr.tree_leaves(t)]
    return other if shapes(other) == shapes(own) else own


@contextlib.contextmanager
def mispaired_gathers():
    """The planted fault of the streamed engine: span k's compute reads
    span k+1's gathered receipt (:func:`mispaired_gathered`)."""
    from repro_torch.core import streaming
    real = streaming.take_gathered
    streaming.take_gathered = mispaired_gathered
    try:
        yield
    finally:
        streaming.take_gathered = real


def engine_grads(trainer, t: int, **kw):
    """One streamed fwd+bwd of this member's batch of step ``t`` on the
    trainer's state (nothing updated): the loss and its grad slices."""
    from repro_torch.core import streaming
    plan = trainer.plan()
    batch = trainer._put_batch(t)
    losses, _, grads = streaming.streamed_loss_and_grad_shards(
        plan, trainer.model.layered, trainer.state.params, [batch],
        pod=trainer.world.pod_of("data"), **kw)
    return losses[0], grads


def streamed_ranks_worker(world, out, inits, runs, seq_len, global_batch,
                          steps, bad, budget):
    """Every rank check of layer-streamed FSDP over ranks in one world:
    :func:`streamed_plan_checks` over this world (data 2 x pod 4) and
    over data 4 x pod 2 on the same ranks; then each of ``runs`` for
    ``steps`` steps, streamed and gather-all, from the streamed checkpoint
    ``inits[name]``, every streamed fwd+bwd's event log held to the
    schedule (``streaming.check_stream_event_log``), rank 0 writing each
    gathered state to ``out/<name>`` and ``out/<name>_gather_all``; one
    fwd+bwd from the first run's final state asynchronous, serial and with
    mispaired gathers planted; two steps of the first run in two
    microbatches (``out/microbatch``); then one streamed step whose batch
    poisons member ``bad``'s mask rows (``out/guard``)."""
    import torch
    from repro_torch.core import streaming
    from repro_torch.launch import mesh
    res = {}
    streamed_plan_checks(world, budget, res, "2x4")
    other = mesh.init_rank_world(4, 2, device_type="cpu", shard_axis="data")
    streamed_plan_checks(other, budget, res, "4x2")
    first = None
    for name, kw in runs.items():
        for streamed, tag in ((True, name), (False, f"{name}_gather_all")):
            trainer = fsdp_trainer(world, "tinyllama-1.1b", inits[name], kw,
                                   seq_len, global_batch, streamed=streamed,
                                   budget=budget)
            plan = trainer.plan()
            plan.stream_log = [] if streamed else None
            res[f"{tag}/losses"] = np.asarray(
                [trainer.step_once(t) for t in range(steps)])
            res[f"{tag}/skipped"] = np.asarray(trainer.skipped_nonfinite)
            if streamed:
                checked = [streaming.check_stream_event_log(r, plan)
                           for r in plan.stream_log]
                plan.stream_log = None
                res[f"{tag}/logs"] = np.asarray(len(checked))
                for k in ("gathers", "span_gathers_live_max",
                          "scatters_in_flight_max", "peak_gathered_bytes",
                          "peak_bound"):
                    res[f"{tag}/log/{k}"] = np.asarray(
                        [c[k] for c in checked])
                cons = trainer.consolidated()
                if cons is not None:
                    _save_tree(res, f"{tag}/cons", flat_tree(cons))
                first = first or trainer
            trainer.save_checkpoint(os.path.join(out, tag))
    loss, grads = engine_grads(first, steps)
    s_loss, serial = engine_grads(first, steps, overlap=False)
    with mispaired_gathers():
        m_loss, mispaired = engine_grads(first, steps)
    res["pair/serial_equal"] = np.asarray(
        float(s_loss) == float(loss)
        and all(torch.equal(a, b) for a, b in zip(serial, grads)))
    res["pair/mispaired_parts"] = np.asarray(not (
        float(m_loss) == float(loss)
        and all(torch.equal(a, b) for a, b in zip(mispaired, grads))))
    for b, x in enumerate(grads):
        res[f"pair/grads/{b}"] = x.numpy()
    name = next(iter(runs))
    trainer = fsdp_trainer(world, "tinyllama-1.1b", inits[name],
                           dict(runs[name], microbatch=2), seq_len,
                           global_batch, streamed=True, budget=budget)
    res["microbatch/losses"] = np.asarray(
        [trainer.step_once(t) for t in range(2)])
    trainer.save_checkpoint(os.path.join(out, "microbatch"))
    trainer = fsdp_trainer(world, "tinyllama-1.1b", inits[name], runs[name],
                           seq_len, global_batch, streamed=True,
                           budget=budget)
    res["guard/skipped"] = np.asarray(poisoned_step(trainer, world, bad,
                                                    "mask"))
    res["guard/count"] = trainer.state.opt_state.count.numpy()
    trainer.save_checkpoint(os.path.join(out, "guard"))
    return res


# ---------------------------------------------------------------------------
# FSDP within a pod under a model axis
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def other_coordinate_partners(plan):
    """The planted fault of the pod view: each rank's butterfly partners
    are the other pods' members at its shard coordinate but at the OTHER
    model coordinate (torch rank XOR 1 at model 2), so slices of two
    coordinates' layouts are averaged together."""
    import dataclasses
    from repro_torch.core import plan as plan_mod
    real = plan.wire
    view = real.world
    ranks = tuple(t if e == view.rank else t ^ 1
                  for e, t in enumerate(view.torch_ranks))
    plan.wire = plan_mod.RankWire(dataclasses.replace(view, torch_ranks=ranks))
    try:
        yield
    finally:
        plan.wire = real


def nan_at_model_rank(trainer, world, bad: int, t: int, pod_min_only: bool
                      ) -> float:
    """Step ``t`` with a NaN in the first element of the gradient of
    member ``bad`` at model rank 1 alone; ``pod_min_only`` (the planted
    fault) leaves the MIN over the model group out of the guard.  Returns
    the step's skipped share."""
    from repro_torch.core import tree as tr
    from repro_torch.train import train_step
    vag, finite = train_step.value_and_grad, train_step.replica_all_finite

    def poisoned(model, params, batch):
        grads, metrics = vag(model, params, batch)
        tr.tree_leaves(grads)[0].view(-1)[0] = float("nan")
        return grads, metrics
    if world.rank == bad and world.model_rank == 1:
        train_step.value_and_grad = poisoned
    if pod_min_only:
        train_step.replica_all_finite = \
            lambda model, grads: train_step.tree_all_finite(grads)
    try:
        trainer.step_once(t)
    finally:
        train_step.value_and_grad, train_step.replica_all_finite = vag, finite
    return trainer.last_metrics["skipped_nonfinite"]


def fsdp_model_worker(world, out, inits, trainer_kw, seq_len, global_batch,
                      steps, bad):
    """FSDP within a pod under a model axis (data x pod x model ranks, the
    shard axis data): the gather-all and the layer-streamed ``Trainer``
    for ``steps`` steps each from the model-1 checkpoint ``inits[tag]``
    (every streamed fwd+bwd's event log held to the schedule), rank 0
    writing the gathered state to ``out/<tag>``; then one group step from
    the gather-all init, right (``out/one_step``) and with the pod view
    pairing the other model coordinate (``out/mispaired``); then one step
    with a NaN in member ``bad``'s gradient at model rank 1, under the
    guard (``guard/count``) and under a guard without the MIN over the
    model group (``pod_min_only/count``)."""
    from repro_torch.core import streaming
    arch = "tinyllama-1.1b"
    make = lambda tag, streamed=False: fsdp_trainer(
        world, arch, inits[tag], trainer_kw, seq_len, global_batch,
        streamed=streamed)
    res = {}
    for tag, streamed in (("gather_all", False), ("streamed", True)):
        trainer = make(tag, streamed)
        plan = trainer.plan()
        plan.stream_log = [] if streamed else None
        res[f"{tag}/losses"] = np.asarray(
            [trainer.step_once(t) for t in range(steps)])
        res[f"{tag}/skipped"] = np.asarray(trainer.skipped_nonfinite)
        if streamed:
            res[f"{tag}/logs"] = np.asarray(len(
                [streaming.check_stream_event_log(r, plan)
                 for r in plan.stream_log]))
            plan.stream_log = None
        res[f"{tag}/slices"] = np.asarray(
            [b.shape[1] for b in trainer.state.params])
        trainer.save_checkpoint(os.path.join(out, tag))
    for tag, planted in (("one_step", False), ("mispaired", True)):
        trainer = make("gather_all")
        if planted:
            with other_coordinate_partners(trainer.plan()):
                trainer.step_once(0)
        else:
            trainer.step_once(0)
        trainer.save_checkpoint(os.path.join(out, tag))
    for tag, planted in (("guard", False), ("pod_min_only", True)):
        trainer = make("gather_all")
        res[f"{tag}/skipped"] = np.asarray(nan_at_model_rank(
            trainer, world, bad, 0, planted))
        res[f"{tag}/count"] = trainer.state.opt_state.count.numpy()
    return res


def _spec_tree(cfg):
    """The whole params tree of ``cfg`` as Specs."""
    from repro_torch.models.convert import PARAM_SPECS
    return PARAM_SPECS[cfg.family](cfg)


def flat_tree(tree, prefix=""):
    """A nested dict of tensors as ``{"a/b/c": tensor}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def world_axes(world):
    """(data, pod) sizes of a rank world's dp axes."""
    sizes = dict(zip(world.axis_names, world.axis_sizes))
    return sizes["data"], sizes.get("pod")


def state_template(cfg, P: int, trainer_kw: dict):
    """A ``(P, ...)`` ReplicaState of Specs for ``cfg`` and the run's
    optimiser (SGD unless ``trainer_kw`` names adamw)."""
    import torch
    from repro_torch.core import tree as tr
    from repro_torch.core.replica import ReplicaState
    from repro_torch.models.convert import PARAM_SPECS
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.sgd import SGDState
    specs = PARAM_SPECS[cfg.family](cfg)
    params = tr.tree_map(lambda s: tr.Spec((P,) + s.shape, s.dtype), specs)
    f32 = tr.tree_map(lambda s: tr.Spec(s.shape, torch.float32), params)
    count = tr.Spec((P,), torch.int32)
    opt = (AdamWState(f32, f32, count)
           if trainer_kw.get("optimizer") == "adamw" else SGDState(f32, count))
    return ReplicaState(params, opt)


WORKERS = {"plan": plan_worker, "trainer": trainer_worker,
           "consolidated": consolidated_worker,
           "model_axis": model_axis_worker, "scheduler": scheduler_worker,
           "routed_count": routed_count_worker,
           "loss_grads": loss_grads_worker,
           "fsdp_ranks": fsdp_ranks_worker,
           "streamed_ranks": streamed_ranks_worker,
           "fsdp_model": fsdp_model_worker}
