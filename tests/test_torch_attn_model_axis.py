"""The port's model axis for the audio family (``models/encdec.py``:
transformer-wmt's token encoder, whisper-medium's frame encoder) and the
vlm family (internvl2-2b: the dense transformer after a patch prefix)
against the JAX package on Auto-typed ``(data, model)`` meshes (ROADMAP.md
F1), on the CPU in float32, at the smoke configs (2 + 2 layers; 2 for the
vlm).

Three JAX subprocesses (4 forced host devices each: transformer-wmt's
training, internvl2-2b's, serving) and two gloo worlds run side by side,
all from the same port-made inputs:

- training, world ``data 2 x model 2``: 3 WAGMA steps at S 2 and tau 2
  from one initial state against the JAX Trainer on a ``(2, 2)`` mesh:
  losses within 1e-6 relative, the gathered params and momenta within
  1e-5 of each leaf's largest magnitude, for whisper-medium and
  internvl2-2b; transformer-wmt's losses likewise, its state after the
  first step against the JAX Trainer's and after the third against the
  port's own model-1 Trainer (transformer-wmt's MLP is a ReLU, whose
  mask flips where float32 sums round differently: the JAX Trainer's
  own ``(2, 1)`` and ``(2, 2)`` runs part by up to 4e-3 of a layer
  norm's largest value after 3 steps, 6e-4 after one); the leaves held
  whole (``enc_pos`` among them) bit-identical over each model group;
  the checkpoint of the gathered state holds what a model-1 run writes
  of it; the encoder output's ``copy_to_model`` left out (each rank's
  cross K/V then send back only their heads' part of its gradient) must
  fail the comparison;
- serving, worlds ``data 2 x model 2`` and ``data 1 x model 2``: prefill
  and 4 greedy decode steps of all three models against the reference's
  ``build_serve_step`` with ``serve_param_shardings``/``cache_shardings``,
  logits within 1e-5 and the tokens equal;
- placement: at model 2 every leaf's split dim is the one the reference's
  sharding cuts; at model 4 too, but for internvl2's KV projections,
  whose 2 KV heads the port holds whole (the reference cuts their
  columns inside a head); ``cache_shardings``' dp entries for the self,
  cross and prefixed caches are the reference's.
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
from repro_torch.models import encdec, vlm
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import cache_shardings

# the losses to 1e-6 relative, every gathered param and momentum leaf to
# 1e-5 of its largest magnitude (the dense family's bounds)
LOSS_RTOL, RTOL = 1e-6, 1e-5
TRAIN_ARCHS = ("transformer-wmt", "whisper-medium", "internvl2-2b")
SERVE_ARCHS = ("transformer-wmt", "whisper-medium", "internvl2-2b")
KW = dict(averager="wagma", group_size=2, tau=2, seq_len=16, global_batch=8,
          seed=0)
STEPS = 3
# name -> (arch, planted fault, steps)
RUNS = {"wmt": ("transformer-wmt", None, STEPS),
        "wmt_step1": ("transformer-wmt", None, 1),
        "wmt_enc_out_unsummed": ("transformer-wmt", "enc_out_unsummed",
                                 STEPS),
        "whisper": ("whisper-medium", None, STEPS),
        "vlm": ("internvl2-2b", None, STEPS)}
PROMPT, SRC_LEN, MAX_LEN, NEW = 8, 12, 16, 4
SERVE_WORLDS = ((2, 2), (1, 2))
# meshes whose param shardings the placement is held to
PLACEMENT_MESHES = ((2, 2), (1, 4))
# cache_shardings cases: mesh (data, model), batch, max_len
CACHE_CASES = [((2, 2), 8, 64), ((2, 2), 3, 33), ((4, 1), 2, 64),
               ((1, 4), 4, 64), ((3, 1), 2, 64)]
# leaves whose split the port leaves out, by (arch, model ranks): the KV
# heads that do not divide over the ranks, held whole
KV_EXCEPTIONS = {("internvl2-2b", 4): ("wk", "wv")}

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
        losses = [tr.step_once(0)]
        save_replica_state(f"{{out}}/jax/{{arch}}/step1",
                           jax.device_get(tr.state))
        losses += [tr.step_once(t) for t in range(1, {steps})]
    save_replica_state(f"{{out}}/jax/{{arch}}", jax.device_get(tr.state))
    np.save(f"{{out}}/jax/{{arch}}/losses.npy", np.asarray(losses))
    print("JAX_ATTN_MODEL_AXIS_DONE")
"""
JAX_SERVE = """
    shard_shapes, specs = {{}}, {{}}
    for arch in {serve_archs!r}:
        cfg = smoke(arch)
        model = build_model(cfg)
        tree = nest(dict(np.load(f"{{out}}/serve/{{arch}}/params/params.npz")))
        prompts = np.load(f"{{out}}/serve/{{arch}}/prompts.npy")
        extra = dict(np.load(f"{{out}}/serve/{{arch}}/extra.npz"))
        for data, n_model in {placement_meshes!r}:
            mesh = make_mesh(data, n_model)
            params = jax.device_put(tree, serve_param_shardings(
                mesh, jax.eval_shape(lambda: tree)))
            flat = jax.tree_util.tree_flatten_with_path(params)[0]
            shard_shapes[f"{{arch}}|{{n_model}}"] = {{
                path_of(p): list(a.addressable_shards[0].data.shape)
                for p, a in flat}}
        pos0 = prompts.shape[1] + (cfg.n_patches if cfg.family == "vlm"
                                   else 0)
        for data, n_model in {serve_worlds!r}:
            mesh = make_mesh(data, n_model)
            with compat.set_mesh(mesh):
                params = jax.device_put(tree, serve_param_shardings(
                    mesh, jax.eval_shape(lambda: tree)))
                rows = NamedSharding(mesh, P("data"))
                batch = {{"tokens": jax.device_put(
                    jnp.asarray(prompts, jnp.int32), rows)}}
                for k, v in extra.items():
                    batch[k] = jax.device_put(
                        jnp.asarray(v, jnp.int32 if k == "src"
                                    else jnp.float32), rows)
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
                                                jnp.asarray(pos0 + i))
                    all_logits.append(logits[:, -1])
                    all_tokens.append(tok[:, 0])
            tag = f"{{arch}}_{{data}}x{{n_model}}"
            np.save(f"{{out}}/jax/serve_{{tag}}_logits.npy",
                    np.stack([np.asarray(a) for a in all_logits], 1))
            np.save(f"{{out}}/jax/serve_{{tag}}_tokens.npy",
                    np.stack([np.asarray(a) for a in all_tokens], 1))
        for smoke_ in (True, False):
            model = build_model(get_config(arch, smoke=smoke_))
            for (data, n_model), batch, max_len in {cache_cases!r}:
                mesh = make_mesh(data, n_model)
                shapes = jax.eval_shape(
                    lambda: model.init_caches(batch, max_len))
                key = f"{{arch}}|{{smoke_}}|{{data}}x{{n_model}}|{{batch}}|{{max_len}}"
                try:
                    tree = cache_shardings(mesh, shapes, batch)
                except ValueError as e:
                    specs[key] = {{"error": str(e)}}
                    continue
                flat = jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
                specs[key] = {{path_of(path):
                              [e if isinstance(e, (str, type(None)))
                               else list(e) for e in s.spec]
                              for path, s in flat}}
    json.dump(shard_shapes, open(f"{{out}}/jax/shard_shapes.json", "w"))
    json.dump(specs, open(f"{{out}}/jax/cache_specs.json", "w"))
    print("JAX_ATTN_MODEL_AXIS_DONE")
"""


def _cfg(arch):
    return rank_runs.smoke_cfg(arch)


def _start_jax(out: str, part: str, **fmt) -> subprocess.Popen:
    """A JAX run (``JAX_TRAIN`` or ``JAX_SERVE``) in a subprocess on 4
    forced host devices."""
    body = (JAX_COMMON + part).format(
        out=out, kw=KW, steps=STEPS, serve_archs=SERVE_ARCHS,
        placement_meshes=PLACEMENT_MESHES, serve_worlds=SERVE_WORLDS,
        max_len=MAX_LEN, new=NEW, cache_cases=CACHE_CASES, **fmt)
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


def serve_inputs(cfg, rng, rows: int) -> dict:
    """What a family's prefill reads beside the tokens: whisper's frame
    embeddings, transformer-wmt's source tokens, internvl2's patches."""
    if cfg.family == "vlm":
        return {"patches": (rng.standard_normal(
            (rows, cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)}
    if cfg.encoder_frames:
        return {"frames": (rng.standard_normal(
            (rows, cfg.encoder_frames, cfg.d_model)) * 0.02
        ).astype(np.float32)}
    return {"src": rng.integers(0, cfg.vocab, (rows, SRC_LEN))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's inputs, then the JAX subprocesses beside the two gloo
    worlds; returns (out, {world: per-rank results})."""
    out = str(tmp_path_factory.mktemp("attn_model_axis"))
    for arch in TRAIN_ARCHS:
        Trainer(_cfg(arch), 2, device="cpu", **KW).save_checkpoint(
            os.path.join(out, "init", arch))
    serves = {}
    for arch in SERVE_ARCHS:
        cfg = _cfg(arch)
        d = os.path.join(out, "serve", arch)
        save_checkpoint(os.path.join(d, "params"), build_model(
            cfg, "cpu").init(torch.Generator().manual_seed(1)))
        rng = np.random.default_rng(0)
        np.save(os.path.join(d, "prompts.npy"),
                rng.integers(0, cfg.vocab, (4, PROMPT)))
        np.savez(os.path.join(d, "extra.npz"), **serve_inputs(cfg, rng, 4))
        serves[arch] = dict(arch=arch, params=os.path.join(d, "params"),
                            prompts=os.path.join(d, "prompts.npy"),
                            extra=os.path.join(d, "extra.npz"),
                            max_len=MAX_LEN, steps=NEW)
    jax_procs = [_start_jax(out, JAX_TRAIN, arch=arch)
                 for arch in TRAIN_ARCHS] + [_start_jax(out, JAX_SERVE)]
    train_runs = {name: dict(arch=arch, init=os.path.join(out, "init", arch),
                             trainer_kw=KW, steps=steps, fault=fault)
                  for name, (arch, fault, steps) in RUNS.items()}
    ranks = {}
    try:
        for data, n_model in SERVE_WORLDS:
            ranks[(data, n_model)] = rank_runs.spawn(
                "model_axis", data * n_model,
                os.path.join(out, f"ranks_{data}x{n_model}"), data=data,
                model=n_model, serves=serves,
                runs=train_runs if data == 2 else {})
        done = [p.communicate(timeout=600) for p in jax_procs]
    finally:
        for p in jax_procs:
            if p.poll() is None:
                p.kill()
    for p, (stdout, stderr) in zip(jax_procs, done):
        assert p.returncode == 0 and "JAX_ATTN_MODEL_AXIS_DONE" in stdout, \
            stderr[-3000:]
    return out, ranks


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_placement_is_the_reference_sharding_but_the_kv_heads(runs, arch):
    """At model 2 and 4 every leaf the reference's ``serve_param_shardings``
    cuts on a dim is one the port's ``placement`` splits on that dim, and
    every other leaf is held whole, but for internvl2's KV projections at
    model 4: its 2 KV heads do not divide over 4 ranks, so the port holds
    them whole where the reference cuts their columns.  The encoder's and
    the cross-attention's projections split by heads, ``src_emb`` by
    vocab, ``enc_pos`` is held whole."""
    out, _ = runs
    cfg = _cfg(arch)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    for n_model in (m for _, m in PLACEMENT_MESHES):
        shapes = json.load(open(os.path.join(out, "jax",
                                             "shard_shapes.json")))[
            f"{arch}|{n_model}"]
        dims = cm.placement(cfg, params, n_model)
        split = {}
        exceptions = KV_EXCEPTIONS.get((arch, n_model), ())

        def check(path, leaf):
            node = dims
            for k in path.split("/"):
                node = node[k]
            cut = [i for i, (a, b) in enumerate(zip(leaf.shape, shapes[path]))
                   if a != b]
            want = cut[0] if cut else None
            if path.split("/")[-1] in exceptions:
                assert (node, want) == (None, len(leaf.shape) - 1), path
            else:
                assert node == want, (n_model, path)
            split[path] = node
        cm.map_with_path(check, params)
        assert len(split) == len(shapes) == len(tr.tree_leaves(params))
        if cfg.family == "audio":
            for stack in ("enc_blocks/attn", "dec_blocks/attn",
                          "dec_blocks/cross"):
                assert split[f"{stack}/wq"] == split[f"{stack}/wk"] == 2
                assert split[f"{stack}/wo"] == 1
            assert split["enc_pos"] is None
            if "src_emb" in split:
                assert split["src_emb"] == 0
        assert split["emb"] == 0


def _flat(tree, path="") -> dict:
    """A cache tree's leaves (tensors, or spec tuples of axis names) by
    their "a/b"-style path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in sorted(tree.items()):
            out.update(_flat(v, f"{path}/{k}" if path else str(k)))
        return out
    return {path: tree}


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_cache_shardings_dp_entries_equal_the_reference(runs, arch):
    """The self and cross caches of the encoder-decoders and the vlm's
    cache with its prefix (smoke and full) on each mesh and batch: the
    port's dp entries are the reference's, and where the reference raises
    the port raises the same ``ValueError``; the model entry sits on the
    KV-head dim where the heads divide."""
    out, _ = runs
    want = json.load(open(os.path.join(out, "jax", "cache_specs.json")))
    checked = raised = 0
    for smoke in (True, False):
        cfg = get_config(arch, smoke=smoke)
        mod = {"audio": encdec, "vlm": vlm}[cfg.family]
        for (data, n_model), batch, max_len in CACHE_CASES:
            key = f"{arch}|{smoke}|{data}x{n_model}|{batch}|{max_len}"
            shapes = mod.init_caches(cfg, batch, max_len, "meta")
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
                if node[3] != "data":                   # the KV heads
                    assert (node[3] == "model") == (
                        shape[3] % n_model == 0 and shape[3] >= n_model)
                checked += 1
    assert checked and raised


# ---------------------------------------------------------------------------
# Training against the JAX Trainer
# ---------------------------------------------------------------------------

def _state_parting(got, want) -> list:
    """The step, phase or count where two gathered states differ, and every
    param and momentum leaf beyond 1e-5 of the leaf's largest
    magnitude."""
    bad = []
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


def _loss_parting(out, ranks, name) -> list:
    """``name``'s losses on each rank beyond 1e-6 relative of the JAX
    run's first steps, and skipped updates."""
    arch, _, steps = RUNS[name]
    want = np.load(os.path.join(out, "jax", arch, "losses.npy"))[:steps]
    bad = []
    for r in ranks:
        if not np.allclose(r[f"{name}/losses"], want, rtol=LOSS_RTOL,
                           atol=0):
            bad.append(("losses", r[f"{name}/losses"], want))
        if float(r[f"{name}/skipped"]):
            bad.append("skipped")
    return bad


def _gathered(out, name):
    cfg = _cfg(RUNS[name][0])
    return load_replica_state(os.path.join(out, "ranks_2x2", name),
                              rank_runs.state_template(cfg, 2, {}))


def _jax_state(out, arch, tag=""):
    return load_replica_state(os.path.join(out, "jax", arch, tag),
                              rank_runs.state_template(_cfg(arch), 2, {}))


def _parting(out, ranks, name) -> list:
    """What parts run ``name``'s ranks from the JAX run after as many
    steps: the losses and the gathered state; empty where they agree."""
    arch, _, steps = RUNS[name]
    return _loss_parting(out, ranks, name) + _state_parting(
        _gathered(out, name), _jax_state(out, arch,
                                         "step1" if steps == 1 else ""))


def _held_whole_and_restored(ranks, name) -> None:
    for r in range(4):
        assert np.array_equal(ranks[r][f"{name}/whole"],
                              ranks[r - r % 2][f"{name}/whole"])
        assert bool(ranks[r][f"{name}/restored"])


@pytest.mark.parametrize("name", ["whisper", "vlm"])
def test_data2_model2_trainer_matches_jax_trainer(runs, name):
    """whisper-medium and internvl2-2b over data 2 x model 2 hold to the
    JAX Trainer; the leaves held whole are bit-identical over each model
    group, and the gathered checkpoint restores at model 2 bit for bit."""
    out, ranks = runs
    ranks = ranks[(2, 2)]
    assert _parting(out, ranks, name) == []
    _held_whole_and_restored(ranks, name)


def test_data2_model2_transformer_wmt_trainer_matches(runs):
    """transformer-wmt over data 2 x model 2: the losses of 3 steps hold
    to the JAX Trainer's, its whole state after the first step to the JAX
    Trainer's and after the third to the port's model-1 Trainer from the
    same initial state (a ReLU mask flips where sums round differently,
    so the two packages' states part past 1e-5 from the second step on);
    the leaves held whole are bit-identical over each model group, and
    the gathered checkpoint restores bit for bit."""
    out, ranks = runs
    ranks = ranks[(2, 2)]
    assert _parting(out, ranks, "wmt_step1") == []
    assert _loss_parting(out, ranks, "wmt") == []
    cfg = _cfg("transformer-wmt")
    init = load_replica_state(os.path.join(out, "init", "transformer-wmt"),
                              rank_runs.state_template(cfg, 2, {}))
    twin = Trainer(cfg, 2, device="cpu", init_state=init, **KW)
    losses = [twin.step_once(t) for t in range(STEPS)]
    np.testing.assert_allclose(ranks[0]["wmt/losses"], losses,
                               rtol=LOSS_RTOL, atol=0)
    assert _state_parting(_gathered(out, "wmt"), twin.gathered_state()) == []
    for name in ("wmt", "wmt_step1"):
        _held_whole_and_restored(ranks, name)


def test_encoder_output_gradient_left_partial_fails_the_jax_comparison(
        runs):
    """Without ``copy_to_model`` on the encoder output each rank's encoder
    gets only its cross heads' part of the gradient: the leaves held whole
    (``enc_pos``, the norms) part over the model group and the gathered
    state parts from the JAX run."""
    out, ranks = runs
    ranks = ranks[(2, 2)]
    assert _parting(out, ranks, "wmt_enc_out_unsummed") != []
    assert not np.array_equal(ranks[0]["wmt_enc_out_unsummed/whole"],
                              ranks[1]["wmt_enc_out_unsummed/whole"])


@pytest.mark.parametrize("name", ["wmt", "whisper", "vlm"])
def test_model2_checkpoint_is_the_model1_checkpoint(runs, tmp_path, name):
    """The model-2 run's checkpoint holds the arrays, checksums and
    manifest a model-1 run writes of the same gathered state, and the
    model-1 Trainer restores it bit for bit."""
    out, _ = runs
    cfg = _cfg(RUNS[name][0])
    src = os.path.join(out, "ranks_2x2", name)
    state = load_replica_state(src, rank_runs.state_template(cfg, 2, {}))
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
    assert json.load(open(tmp_path / "manifest.json")) == ma
    save_replica_state(str(tmp_path / "again"), state,
                       metadata={"arch": cfg.name})
    assert json.load(open(tmp_path / "again" / "manifest.json")) == ma


# ---------------------------------------------------------------------------
# Serving against the reference's sharded serve step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", SERVE_WORLDS,
                         ids=[f"data{d}xmodel{m}" for d, m in SERVE_WORLDS])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_matches_jax_serve_step(runs, arch, world):
    out, ranks = runs
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
