"""The port's model axis for the hybrid family (recurrentgemma: Megatron's
split of the RG-LRU layers, the local attention and the MLPs over the
model ranks of each replica) against the JAX package on an Auto-typed
``(data, model)`` mesh (ROADMAP.md F1), on the CPU in float32.

Two JAX subprocesses (4 forced host devices each: training, serving) and
two gloo worlds run side by side, all from the same port-made inputs, on recurrentgemma-2b smoke at 5
layers (one superblock and the two trailing recurrent layers):

- training, world ``data 2 x model 2``: 3 WAGMA steps at S 2 and tau 2
  from one initial state against the JAX Trainer on a ``(2, 2)`` mesh:
  losses within 1e-6 relative, the gathered params and momenta within
  1e-5 of each leaf's largest magnitude; the leaves held whole
  bit-identical over each model group; the checkpoint of the gathered
  state holds the arrays and checksums a model-1 run writes of it and
  restores bit for bit at model 2 and at model 1; ``w_r``'s gradient
  left partial (its ``copy_to_model`` left out) must fail the comparison;
- serving, worlds ``data 2 x model 2`` and ``data 1 x model 2``: prefill
  and 4 greedy decode steps against the reference's ``build_serve_step``
  with ``serve_param_shardings``/``cache_shardings``, logits within 1e-5
  and the tokens equal;
- placement: every leaf's split dim is the one the reference's sharding
  cuts, but for the KV projections, whose one KV head the port holds
  whole; ``cache_shardings``' dp entries for the rglru caches are the
  reference's.
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

from repro_torch.checkpoint import (load_replica_state, save_checkpoint,
                                    save_replica_state)
from repro_torch.configs import get_config
from repro_torch.core import tree as tr
from repro_torch.launch.train import Trainer
from repro_torch.models import common as cm
from repro_torch.models import rglru
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import cache_shardings

# the losses to 1e-6 relative, every gathered param and momentum leaf to
# 1e-5 of its largest magnitude (the dense family's bounds)
LOSS_RTOL, RTOL = 1e-6, 1e-5
ARCH, LAYERS = "recurrentgemma-2b", 5
KW = dict(averager="wagma", group_size=2, tau=2, seq_len=16, global_batch=8,
          seed=0)
STEPS = 3
# name -> planted fault
RUNS = {"train": None, "w_r_unsummed": "w_r_unsummed"}
PROMPT, MAX_LEN, NEW = 8, 16, 4
SERVE_WORLDS = ((2, 2), (1, 2))
# cache_shardings cases: mesh (data, model), batch, max_len
CACHE_CASES = [((2, 2), 8, 64), ((2, 2), 3, 33), ((4, 1), 2, 64),
               ((1, 4), 4, 64), ((3, 1), 2, 64)]
# the leaves whose split the port leaves out: one KV head on two ranks,
# held whole (the reference cuts the head's columns)
KV_PROJECTIONS = ("wk", "wv")

# the JAX runs: two subprocesses side by side, training and serving
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

    cfg = get_config({arch!r}, smoke=True).variant(dtype="float32",
                                                   n_layers={layers})
"""
JAX_TRAIN = """
    mesh = make_mesh(2, 2)
    first = Trainer(cfg, mesh, **kw)
    init = load_replica_state(f"{{out}}/init", jax.device_get(first.state))
    tr = Trainer(cfg, mesh, init_state=init, **kw)
    with compat.set_mesh(mesh):
        losses = [tr.step_once(t) for t in range({steps})]
    save_replica_state(f"{{out}}/jax/train", jax.device_get(tr.state))
    np.save(f"{{out}}/jax/train/losses.npy", np.asarray(losses))
    print("JAX_RGLRU_MODEL_AXIS_DONE")
"""
JAX_SERVE = """
    model = build_model(cfg)
    tree = nest(dict(np.load(f"{{out}}/serve/params/params.npz")))
    prompts = np.load(f"{{out}}/serve/prompts.npy")
    for data, n_model in {serve_worlds!r}:
        mesh = make_mesh(data, n_model)
        with compat.set_mesh(mesh):
            params = jax.device_put(tree, serve_param_shardings(
                mesh, jax.eval_shape(lambda: tree)))
            if (data, n_model) == (2, 2):
                flat = jax.tree_util.tree_flatten_with_path(params)[0]
                json.dump({{path_of(p): list(a.addressable_shards[0].data.shape)
                           for p, a in flat}},
                          open(f"{{out}}/jax/shard_shapes.json", "w"))
            tokens = jax.device_put(jnp.asarray(prompts, jnp.int32),
                                    NamedSharding(mesh, P("data")))
            logits, caches = build_prefill(model, mesh, {max_len})(
                params, {{"tokens": tokens}})
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
        np.save(f"{{out}}/jax/serve_{{data}}x{{n_model}}_logits.npy",
                np.stack([np.asarray(a) for a in all_logits], 1))
        np.save(f"{{out}}/jax/serve_{{data}}x{{n_model}}_tokens.npy",
                np.stack([np.asarray(a) for a in all_tokens], 1))

    specs = {{}}
    for smoke in (True, False):
        model = build_model(get_config({arch!r}, smoke=smoke))
        for (data, n_model), batch, max_len in {cache_cases!r}:
            mesh = make_mesh(data, n_model)
            shapes = jax.eval_shape(lambda: model.init_caches(batch, max_len))
            key = f"{{smoke}}|{{data}}x{{n_model}}|{{batch}}|{{max_len}}"
            try:
                tree = cache_shardings(mesh, shapes, batch)
            except ValueError as e:
                specs[key] = {{"error": str(e)}}
                continue
            flat = jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
            specs[key] = {{path_of(path):
                          [e if isinstance(e, (str, type(None))) else list(e)
                           for e in s.spec] for path, s in flat}}
    json.dump(specs, open(f"{{out}}/jax/cache_specs.json", "w"))
    print("JAX_RGLRU_MODEL_AXIS_DONE")
"""


def _cfg():
    return get_config(ARCH, smoke=True).variant(dtype="float32",
                                                n_layers=LAYERS)


def _start_jax(out: str, part: str) -> subprocess.Popen:
    """A JAX run (``JAX_TRAIN`` or ``JAX_SERVE``) in a subprocess on 4
    forced host devices."""
    body = (JAX_COMMON + part).format(
        out=out, kw=KW, arch=ARCH, layers=LAYERS, steps=STEPS,
        serve_worlds=SERVE_WORLDS, max_len=MAX_LEN, new=NEW,
        cache_cases=CACHE_CASES)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's inputs, then the JAX subprocess beside the two gloo
    worlds; returns (out, {world: per-rank results})."""
    out = str(tmp_path_factory.mktemp("rglru_model_axis"))
    cfg = _cfg()
    Trainer(cfg, 2, device="cpu", **KW).save_checkpoint(
        os.path.join(out, "init"))
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    save_checkpoint(os.path.join(out, "serve", "params"), params)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, PROMPT))
    np.save(os.path.join(out, "serve", "prompts.npy"), prompts)
    jax_procs = [_start_jax(out, part) for part in (JAX_TRAIN, JAX_SERVE)]
    serve = dict(arch=ARCH, n_layers=LAYERS,
                 params=os.path.join(out, "serve", "params"),
                 prompts=os.path.join(out, "serve", "prompts.npy"),
                 max_len=MAX_LEN, steps=NEW)
    train_runs = {name: dict(arch=ARCH, n_layers=LAYERS,
                             init=os.path.join(out, "init"), trainer_kw=KW,
                             steps=STEPS, fault=fault)
                  for name, fault in RUNS.items()}
    ranks = {}
    try:
        for data, n_model in SERVE_WORLDS:
            ranks[(data, n_model)] = rank_runs.spawn(
                "model_axis", data * n_model,
                os.path.join(out, f"ranks_{data}x{n_model}"), data=data,
                model=n_model, serve=serve,
                runs=train_runs if data == 2 else {})
        done = [p.communicate(timeout=600) for p in jax_procs]
    finally:
        for p in jax_procs:
            if p.poll() is None:
                p.kill()
    for p, (stdout, stderr) in zip(jax_procs, done):
        assert p.returncode == 0 and "JAX_RGLRU_MODEL_AXIS_DONE" in stdout, \
            stderr[-3000:]
    return out, ranks


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def test_placement_is_the_reference_sharding_but_the_kv_head(runs):
    """On the ``(2, 2)`` mesh every leaf the reference's
    ``serve_param_shardings`` cuts on a dim is one the port's
    ``placement`` splits on that dim, and every other leaf is held whole,
    but for the KV projections: the one KV head cannot split into whole
    heads over two ranks, so the port holds it whole; the split leaves are
    the recurrent layers' ``w_x``, ``w_gate``, ``conv_w`` (by channel) and
    ``w_out`` (by row), the attention's ``wq``/``wo``, the MLPs and the
    vocab of the tied embedding, and ``w_r``, ``w_i`` and ``lam`` are held
    whole."""
    out, _ = runs
    cfg = _cfg()
    shapes = json.load(open(os.path.join(out, "jax", "shard_shapes.json")))
    specs = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    dims = cm.placement(cfg, specs, 2)
    split = {}

    def check(path, leaf):
        node = dims
        for k in path.split("/"):
            node = node[k]
        cut = [i for i, (a, b) in enumerate(zip(leaf.shape, shapes[path]))
               if a != b]
        want = cut[0] if cut else None
        if path.split("/")[-1] in KV_PROJECTIONS:
            assert (node, want) == (None, len(leaf.shape) - 1), path
        else:
            assert node == want, path
        split[path] = node
    cm.map_with_path(check, specs)
    assert len(split) == len(shapes) == len(tr.tree_leaves(specs))
    for name in ("w_x", "w_gate", "conv_w"):
        assert split[f"blocks/rec1/{name}"] == 2
        assert split[f"tail/{name}"] == 2
    assert split["blocks/rec2/w_out"] == 1 and split["emb"] == 0
    for name in ("w_r", "w_i", "lam"):
        assert split[f"blocks/rec1/{name}"] is None


def _flat(tree, path="") -> dict:
    """A cache tree's leaves (tensors, or spec tuples of axis names) by
    their "a/0"-style path."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and any(isinstance(e, (tuple, dict)) or
                                         hasattr(e, "shape") for e in tree):
        items = enumerate(tree)
    else:
        return {path: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{path}/{k}" if path else str(k)))
    return out


def test_rglru_cache_shardings_dp_entries_equal_the_reference(runs):
    """recurrentgemma's caches (smoke and full) on each mesh and batch: the
    port's dp entries are the reference's, and where the reference raises
    the port raises the same ``ValueError``; the model entry sits on a
    recurrent state's channels and on the ring cache's KV-head dim where
    they divide."""
    out, _ = runs
    want = json.load(open(os.path.join(out, "jax", "cache_specs.json")))
    checked = raised = 0
    for smoke in (True, False):
        cfg = get_config(ARCH, smoke=smoke)
        for (data, n_model), batch, max_len in CACHE_CASES:
            key = f"{smoke}|{data}x{n_model}|{batch}|{max_len}"
            shapes = rglru.init_caches(cfg, batch, max_len, "meta")
            mesh = {"data": data, "model": n_model}
            if "error" in want[key]:
                with pytest.raises(ValueError) as e:
                    cache_shardings(mesh, shapes, batch)
                assert str(e.value) == want[key]["error"]
                raised += 1
                continue
            got, flat = _flat(cache_shardings(mesh, shapes, batch)), \
                _flat(shapes)
            assert sorted(got) == sorted(want[key])
            for path, w in want[key].items():
                node, shape = got[path], cm.shape_of(flat[path])
                w = [None if e == "model" else e for e in w]
                w += [None] * (len(node) - len(w))
                assert [None if e == "model" else e for e in node] == w, \
                    (key, path)
                # channels of a recurrent state, the KV heads of the ring
                i = len(shape) - (2 if len(shape) >= 5 else 1)
                if node[i] != "data":
                    assert (node[i] == "model") == (
                        shape[i] % n_model == 0 and shape[i] >= n_model)
                checked += 1
    assert checked and raised


# ---------------------------------------------------------------------------
# Training against the JAX Trainer
# ---------------------------------------------------------------------------

def _template():
    return rank_runs.state_template(_cfg(), 2, {})


def _parting(out, ranks, name) -> list:
    """What parts run ``name``'s ranks from the JAX run: the losses beyond
    1e-6 relative, the step, phase or count, and every gathered leaf
    beyond 1e-5 of the leaf's largest magnitude; empty where they
    agree."""
    want_losses = np.load(os.path.join(out, "jax", "train", "losses.npy"))
    bad = []
    for r in ranks:
        if not np.allclose(r[f"{name}/losses"], want_losses,
                           rtol=LOSS_RTOL, atol=0):
            bad.append(("losses", r[f"{name}/losses"], want_losses))
        if float(r[f"{name}/skipped"]):
            bad.append("skipped")
    got = load_replica_state(os.path.join(out, "ranks_2x2", name),
                             _template())
    want = load_replica_state(os.path.join(out, "jax", "train"), _template())
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


def test_data2_model2_hybrid_trainer_matches_jax_trainer(runs):
    out, ranks = runs
    ranks = ranks[(2, 2)]
    assert _parting(out, ranks, "train") == []
    for r in range(4):
        # the leaves held whole: bit-identical over each model group
        assert np.array_equal(ranks[r]["train/whole"],
                              ranks[r - r % 2]["train/whole"])
        # the gathered checkpoint restores at model 2 bit for bit
        assert bool(ranks[r]["train/restored"])


def test_w_r_gradient_left_partial_fails_the_jax_comparison(runs):
    """Without ``copy_to_model`` on ``w_r`` each rank updates only its own
    columns of it: the leaves held whole part over the model group and
    the gathered state parts from the JAX run."""
    out, ranks = runs
    ranks = ranks[(2, 2)]
    assert _parting(out, ranks, "w_r_unsummed") != []
    assert not np.array_equal(ranks[0]["w_r_unsummed/whole"],
                              ranks[1]["w_r_unsummed/whole"])


def test_model2_hybrid_checkpoint_is_the_model1_checkpoint(runs, tmp_path):
    """The model-2 run's checkpoint holds the arrays, checksums and
    manifest a model-1 run writes of the same gathered state, and the
    model-1 Trainer restores it bit for bit."""
    out, _ = runs
    cfg = _cfg()
    src = os.path.join(out, "ranks_2x2", "train")
    state = load_replica_state(src, _template())
    trainer = Trainer(cfg, 2, device="cpu", init_state=state, **KW)
    for a, b in zip(tr.tree_leaves((trainer.state.params,
                                    trainer.state.opt_state)),
                    tr.tree_leaves((state.params, state.opt_state))):
        assert torch.equal(a, b)
    trainer.save_checkpoint(str(tmp_path))
    for f in ("params.npz", "opt_state.npz"):
        a, b = np.load(os.path.join(src, f)), np.load(tmp_path / f)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    ma = json.load(open(os.path.join(src, "manifest.json")))
    mb = json.load(open(tmp_path / "manifest.json"))
    assert ma == mb
    save_replica_state(str(tmp_path / "again"), state,
                       metadata={"arch": cfg.name})
    assert json.load(open(tmp_path / "again" / "manifest.json")) == ma


# ---------------------------------------------------------------------------
# Serving against the reference's sharded serve step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", SERVE_WORLDS,
                         ids=[f"data{d}xmodel{m}" for d, m in SERVE_WORLDS])
def test_hybrid_serving_matches_jax_serve_step(runs, world):
    out, ranks = runs
    data, n_model = world
    tag = f"{data}x{n_model}"
    want_logits = np.load(os.path.join(out, "jax", f"serve_{tag}_logits.npy"))
    want_tokens = np.load(os.path.join(out, "jax", f"serve_{tag}_tokens.npy"))
    rows = want_tokens.shape[0] // data
    for r, res in enumerate(ranks[world]):
        d = r // n_model
        sl = slice(d * rows, (d + 1) * rows)
        np.testing.assert_allclose(res["serve/logits"], want_logits[sl],
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(res["serve/tokens"], want_tokens[sl])
