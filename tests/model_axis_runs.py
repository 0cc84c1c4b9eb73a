"""What the model-axis differential tests of the ssm and moe families
(``tests/test_torch_xlstm_model_axis.py``, ``test_torch_moe_model_axis.py``)
share: the JAX runs, each in a subprocess on 4 forced host devices with
Auto-typed ``(data, model)`` meshes (ROADMAP.md F1), and the comparisons
of the port's gloo worlds with them.

- ``JAX_TRAIN``: the JAX ``Trainer`` over ``(2, 2)`` from the port's
  initial state, its losses and final state;
- ``JAX_SERVE``: the reference's ``build_prefill``/``build_serve_step``
  under ``serve_param_shardings``/``cache_shardings`` over each serving
  mesh; the shard shape of every param leaf (smoke and full configs, by
  ``NamedSharding.shard_shape``, nothing allocated) and the cache specs.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

import rank_runs
from subproc import SRC

from repro_torch.checkpoint import load_replica_state, save_checkpoint
from repro_torch.core import tree as tr
from repro_torch.launch.train import Trainer
from repro_torch.models.registry import build_model

# the losses to 1e-6 relative, every gathered param and momentum leaf to
# 1e-5 of its largest magnitude (the dense family's bounds)
LOSS_RTOL, RTOL = 1e-6, 1e-5
KW = dict(averager="wagma", group_size=2, tau=2, seq_len=16, global_batch=8,
          seed=0)
STEPS = 3
PROMPT, MAX_LEN, NEW = 8, 16, 4
SERVE_WORLDS = ((2, 2), (1, 2))
# cache_shardings cases: mesh (data, model), batch, max_len
CACHE_CASES = [((2, 2), 8, 64), ((2, 2), 3, 33), ((4, 1), 2, 64),
               ((1, 4), 4, 64), ((3, 1), 2, 64)]
# the model axes whose param shardings the placement is held to
PLACEMENT_MODELS = (2, 4)
DONE = "JAX_EP_MODEL_AXIS_DONE"

JAX_COMMON = """
    from jax.sharding import AxisType
    from repro.checkpoint import load_replica_state, save_replica_state
    from repro.configs import get_config
    from repro.launch.train import Trainer
    from repro.models.registry import build_model
    from repro.serve.decode import (build_prefill, build_serve_step,
                                    cache_shardings, serve_param_shardings)
    out = {out!r}
    kw = {kw!r}
    os.makedirs(f"{{out}}/jax", exist_ok=True)

    def make_mesh(data, model):
        return jax.make_mesh((data, model), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:data * model])

    def nest(flat):
        tree = {{}}
        for key, val in flat.items():
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {{}})
            node[parts[-1]] = jnp.asarray(val)
        return tree

    def path_of(path):
        return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def smoke(arch):
        return get_config(arch, smoke=True).variant(dtype="float32")
"""
JAX_TRAIN = """
    arch = {arch!r}
    cfg = smoke(arch)
    mesh = make_mesh(2, 2)
    first = Trainer(cfg, mesh, **kw)
    init = load_replica_state(f"{{out}}/init/{{arch}}",
                              jax.device_get(first.state))
    tr = Trainer(cfg, mesh, init_state=init, **kw)
    with compat.set_mesh(mesh):
        losses = [tr.step_once(t) for t in range({steps})]
    save_replica_state(f"{{out}}/jax/{{arch}}", jax.device_get(tr.state))
    np.save(f"{{out}}/jax/{{arch}}/losses.npy", np.asarray(losses))
    print({done!r})
"""
JAX_SERVE = """
    shard_shapes, specs = {{}}, {{}}
    for arch in {archs!r}:
        for smoke_ in (True, False):
            cfg = get_config(arch, smoke=smoke_)
            model = build_model(cfg)
            shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
            for n_model in {placement_models!r}:
                mesh = make_mesh(1, n_model)
                shardings = serve_param_shardings(mesh, shapes)
                flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
                sh = jax.tree_util.tree_leaves(
                    shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
                shard_shapes[f"{{arch}}|{{smoke_}}|{{n_model}}"] = {{
                    path_of(p): list(s.shard_shape(a.shape))
                    for (p, a), s in zip(flat, sh)}}
            for (data, n_model), batch, max_len in {cache_cases!r}:
                mesh = make_mesh(data, n_model)
                cshapes = jax.eval_shape(
                    lambda: model.init_caches(batch, max_len))
                key = f"{{arch}}|{{smoke_}}|{{data}}x{{n_model}}|{{batch}}|{{max_len}}"
                try:
                    tree = cache_shardings(mesh, cshapes, batch)
                except ValueError as e:
                    specs[key] = {{"error": str(e)}}
                    continue
                flat = jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
                specs[key] = {{path_of(path):
                              [e if isinstance(e, (str, type(None)))
                               else list(e) for e in s.spec]
                              for path, s in flat}}
        cfg = smoke(arch)
        model = build_model(cfg)
        tree = nest(dict(np.load(f"{{out}}/serve/{{arch}}/params/params.npz")))
        prompts = np.load(f"{{out}}/serve/{{arch}}/prompts.npy")
        for data, n_model in {serve_worlds!r}:
            mesh = make_mesh(data, n_model)
            with compat.set_mesh(mesh):
                params = jax.device_put(tree, serve_param_shardings(
                    mesh, jax.eval_shape(lambda: tree)))
                rows = NamedSharding(mesh, P("data"))
                batch = {{"tokens": jax.device_put(
                    jnp.asarray(prompts, jnp.int32), rows)}}
                logits, caches = build_prefill(model, mesh, {max_len})(
                    params, batch)
                caches = jax.device_put(caches, cache_shardings(
                    mesh, jax.eval_shape(lambda: caches), prompts.shape[0]))
                serve = build_serve_step(model, mesh)
                masked = jnp.where(jnp.arange(logits.shape[-1]) < cfg.vocab,
                                   logits, -1e30)
                tok = jnp.argmax(masked[:, -1], -1).astype(jnp.int32)[:, None]
                all_logits, all_tokens = [logits[:, -1]], [tok[:, 0]]
                for i in range({new}):
                    tok, logits, caches = serve(params, caches, tok,
                                                jnp.asarray(prompts.shape[1] + i))
                    all_logits.append(logits[:, -1])
                    all_tokens.append(tok[:, 0])
            tag = f"{{arch}}_{{data}}x{{n_model}}"
            np.save(f"{{out}}/jax/serve_{{tag}}_logits.npy",
                    np.stack([np.asarray(a) for a in all_logits], 1))
            np.save(f"{{out}}/jax/serve_{{tag}}_tokens.npy",
                    np.stack([np.asarray(a) for a in all_tokens], 1))
    json.dump(shard_shapes, open(f"{{out}}/jax/shard_shapes.json", "w"))
    json.dump(specs, open(f"{{out}}/jax/cache_specs.json", "w"))
    print({done!r})
"""


def smoke(arch):
    return rank_runs.smoke_cfg(arch)


def start_jax(out: str, part: str, **fmt) -> subprocess.Popen:
    """A JAX run (``JAX_TRAIN`` or ``JAX_SERVE``) in a subprocess on 4
    forced host devices."""
    body = (JAX_COMMON + part).format(
        out=out, kw=KW, steps=STEPS, serve_worlds=SERVE_WORLDS,
        placement_models=PLACEMENT_MODELS, max_len=MAX_LEN, new=NEW,
        cache_cases=CACHE_CASES, done=DONE, **fmt)
    script = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        import sys, json
        sys.path.insert(0, {SRC!r})
        import jax, jax.numpy as jnp
        import numpy as np
        from jax.sharding import PartitionSpec as P, NamedSharding
        from repro import compat
    """) + textwrap.dedent(body)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)


def run_all(out: str, archs, runs: dict) -> dict:
    """The port's inputs (each arch's initial training state and serving
    weights and prompts), then the JAX runs (a training run an arch and one
    serving run) beside the port's gloo worlds (``runs``: name -> (arch,
    planted fault), trained over data 2 x model 2; every arch served over
    each of ``SERVE_WORLDS``).  Returns {world: per-rank results}."""
    serves = {}
    for arch in archs:
        cfg = smoke(arch)
        Trainer(cfg, 2, device="cpu", **KW).save_checkpoint(
            os.path.join(out, "init", arch))
        d = os.path.join(out, "serve", arch)
        save_checkpoint(os.path.join(d, "params"), build_model(
            cfg, "cpu").init(torch.Generator().manual_seed(1)))
        np.save(os.path.join(d, "prompts.npy"), np.random.default_rng(
            0).integers(0, cfg.vocab, (4, PROMPT)))
        serves[arch] = dict(arch=arch, params=os.path.join(d, "params"),
                            prompts=os.path.join(d, "prompts.npy"),
                            max_len=MAX_LEN, steps=NEW)
    procs = [start_jax(out, JAX_TRAIN, arch=arch) for arch in archs] + [
        start_jax(out, JAX_SERVE, archs=tuple(archs))]
    train_runs = {name: dict(arch=arch, init=os.path.join(out, "init", arch),
                             trainer_kw=KW, steps=STEPS, fault=fault)
                  for name, (arch, fault) in runs.items()}
    ranks = {}
    try:
        for data, n_model in SERVE_WORLDS:
            ranks[(data, n_model)] = rank_runs.spawn(
                "model_axis", data * n_model,
                os.path.join(out, f"ranks_{data}x{n_model}"), data=data,
                model=n_model, serves=serves,
                runs=train_runs if data == 2 else {})
        done = [p.communicate(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (stdout, stderr) in zip(procs, done):
        assert p.returncode == 0 and DONE in stdout, stderr[-3000:]
    return ranks


def parting(out: str, ranks, name: str, arch: str) -> list:
    """What parts run ``name``'s ranks from the JAX run of ``arch``: the
    losses beyond 1e-6 relative, a skipped update, the step, phase or
    count, and every gathered param and momentum leaf beyond 1e-5 of its
    largest magnitude; empty where they agree."""
    cfg = smoke(arch)
    want_losses = np.load(os.path.join(out, "jax", arch, "losses.npy"))
    bad = []
    for r in ranks:
        if not np.allclose(r[f"{name}/losses"], want_losses, rtol=LOSS_RTOL,
                           atol=0):
            bad.append(("losses", r[f"{name}/losses"], want_losses))
        if float(r[f"{name}/skipped"]):
            bad.append("skipped")
    template = rank_runs.state_template(cfg, 2, {})
    got = load_replica_state(os.path.join(out, "ranks_2x2", name), template)
    want = load_replica_state(os.path.join(out, "jax", arch), template)
    if (got.step, got.phase) != (want.step, want.phase) or not torch.equal(
            got.opt_state.count, want.opt_state.count):
        bad.append("step, phase or count")
    for tag, g_tree, w_tree in (("params", got.params, want.params),
                                ("momentum", got.opt_state.momentum,
                                 want.opt_state.momentum)):
        for g, w in zip(tr.tree_leaves(g_tree), tr.tree_leaves(w_tree)):
            scale = float(w.abs().max()) or 1.0
            if not np.allclose(g.numpy(), w.numpy(), rtol=RTOL,
                               atol=RTOL * scale):
                bad.append((tag, float((g - w).abs().max()), scale))
    return bad


def held_whole_and_restored(ranks, name: str) -> None:
    """The leaves held whole bit-identical over each model group of data 2
    x model 2, and the gathered checkpoint restored bit for bit."""
    for r in range(4):
        assert np.array_equal(ranks[r][f"{name}/whole"],
                              ranks[r - r % 2][f"{name}/whole"])
        assert bool(ranks[r][f"{name}/restored"])


def check_serving(out: str, ranks, arch: str, world) -> None:
    """Each rank's gathered logits (prefill and each decode step) within
    1e-5 of the reference's rows of its dp rank, and the tokens equal."""
    data, n_model = world
    tag = f"{arch}_{data}x{n_model}"
    want_logits = np.load(os.path.join(out, "jax", f"serve_{tag}_logits.npy"))
    want_tokens = np.load(os.path.join(out, "jax", f"serve_{tag}_tokens.npy"))
    rows = want_tokens.shape[0] // data
    for r, res in enumerate(ranks[world]):
        d = r // n_model
        sl = slice(d * rows, (d + 1) * rows)
        np.testing.assert_allclose(res[f"{arch}/serve/logits"],
                                   want_logits[sl], rtol=0, atol=1e-5)
        np.testing.assert_array_equal(res[f"{arch}/serve/tokens"],
                                      want_tokens[sl])


def shard_shapes(out: str) -> dict:
    return json.load(open(os.path.join(out, "jax", "shard_shapes.json")))


def cache_specs(out: str) -> dict:
    return json.load(open(os.path.join(out, "jax", "cache_specs.json")))


def _is_leaf(x) -> bool:
    """A tensor or Spec, a placement's split dim (an int or None), or a
    spec tuple (axis names, a tuple of them, or None) or a shape tuple
    (ints)."""
    if hasattr(x, "shape") or x is None or isinstance(x, int):
        return True
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (int, str)) or (
            isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def flat(tree, path="") -> dict:
    """A tree's leaves by their "a/b"-style path, as the reference's
    ``path_of`` names them (sequence entries by index)."""
    if _is_leaf(tree):
        return {path: tree}
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    out = {}
    for k, v in items:
        out.update(flat(v, f"{path}/{k}" if path else str(k)))
    return out
