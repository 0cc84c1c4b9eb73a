"""The port's model axis for the dense family (Megatron's split over the
model ranks of each replica) against the JAX package on an Auto-typed
``(data, model)`` mesh (ROADMAP.md F1), on the CPU in float32.

One JAX subprocess (4 forced host devices) and two gloo worlds run side by
side, all from the same port-made inputs:

- the spec tables: ``spec_for_param`` against the reference's for every
  leaf of every config, the dp entries of ``cache_shardings`` against the
  reference's (and its ``ValueError``) for the dense configs' caches;
- training, world ``data 2 x model 2``: tinyllama and qwen3 smoke, 3 WAGMA
  steps at S 2 and tau 2 from one initial state, against the JAX Trainer
  on a ``(2, 2)`` mesh: losses within 1e-6 relative, the gathered params
  and momenta within 1e-5 of each leaf's largest magnitude; the leaves
  held whole bit-identical over each model group; the checkpoint of the
  gathered state holds the arrays and checksums a model-1 run writes of
  it, and restores bit for bit at model 2 and at model 1; two planted
  faults (the backward all-reduce of *f* left out, qwen3's ``q_norm``
  gradient left unsummed) must fail the comparison;
- each rank's attention over the KV heads it reads, against the whole
  attention's heads (KV split, read as a run, or read head by head);
- serving, worlds ``data 2 x model 2`` and ``data 1 x model 4``
  (tinyllama smoke: 2 KV heads on 4 ranks, computed whole): prefill and 4
  greedy decode steps against the reference's ``build_serve_step`` with
  ``serve_param_shardings``/``cache_shardings``, logits within 1e-5 and
  the tokens equal.
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

from repro.models import common as jcm
from repro_torch.checkpoint import (load_replica_state, save_checkpoint,
                                    save_replica_state)
from repro_torch.configs import get_config
from repro_torch.configs import _ALIASES
from repro_torch.core import tree as tr
from repro_torch.launch.train import Trainer
from repro_torch.models import common as cm
from repro_torch.models import transformer as tfm
from repro_torch.models.convert import PARAM_SPECS
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import cache_shardings

# the losses to 1e-6 relative (measured 7.6e-8), every gathered param and
# momentum leaf to 1e-5 of its largest magnitude (measured 1.8e-6)
LOSS_RTOL, RTOL = 1e-6, 1e-5
ARCHS = ("tinyllama-1.1b", "qwen3-0.6b")
DENSE = ("tinyllama-1.1b", "qwen3-0.6b", "gemma3-12b", "starcoder2-7b")
KW = dict(averager="wagma", group_size=2, tau=2, seq_len=16, global_batch=8,
          seed=0)
STEPS = 3
# name -> (arch, planted fault)
RUNS = {"tinyllama-1.1b": ("tinyllama-1.1b", None),
        "qwen3-0.6b": ("qwen3-0.6b", None),
        "no_f_backward": ("tinyllama-1.1b", "no_f_backward"),
        "q_norm_unsummed": ("qwen3-0.6b", "q_norm_unsummed")}
SERVE_ARCH, PROMPT, MAX_LEN, NEW = "tinyllama-1.1b", 8, 16, 4
SERVE_WORLDS = ((2, 2), (1, 4))
# cache_shardings cases: mesh (data, model), batch, max_len
CACHE_CASES = [((2, 2), 8, 64), ((2, 2), 3, 33), ((4, 1), 2, 64),
               ((1, 4), 4, 64)]

JAX_SCRIPT = """
    from jax.sharding import AxisType
    from repro.checkpoint import load_replica_state, save_replica_state
    from repro.configs import get_config
    from repro.launch.train import Trainer
    from repro.models.registry import build_model
    from repro.serve.decode import (build_prefill, build_serve_step,
                                    cache_shardings, serve_param_shardings)
    out = {out!r}
    kw = {kw!r}

    def make_mesh(data, model):
        return jax.make_mesh((data, model), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2)

    def nest(flat):
        tree = {{}}
        for key, val in flat.items():
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {{}})
            node[parts[-1]] = jnp.asarray(val)
        return tree

    for arch in {archs!r}:
        cfg = get_config(arch, smoke=True).variant(dtype="float32")
        mesh = make_mesh(2, 2)
        first = Trainer(cfg, mesh, **kw)
        init = load_replica_state(f"{{out}}/init/{{arch}}",
                                  jax.device_get(first.state))
        tr = Trainer(cfg, mesh, init_state=init, **kw)
        with compat.set_mesh(mesh):
            losses = [tr.step_once(t) for t in range({steps})]
        save_replica_state(f"{{out}}/jax/{{arch}}", jax.device_get(tr.state))
        np.save(f"{{out}}/jax/{{arch}}/losses.npy", np.asarray(losses))

    cfg = get_config({serve_arch!r}, smoke=True).variant(dtype="float32")
    model = build_model(cfg)
    tree = nest(dict(np.load(f"{{out}}/serve/params/params.npz")))
    prompts = np.load(f"{{out}}/serve/prompts.npy")
    for data, n_model in {serve_worlds!r}:
        mesh = make_mesh(data, n_model)
        with compat.set_mesh(mesh):
            params = jax.device_put(tree, serve_param_shardings(
                mesh, jax.eval_shape(lambda: tree)))
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
    for arch in {dense!r}:
        for smoke in (True, False):
            cfg = get_config(arch, smoke=smoke)
            model = build_model(cfg)
            for (data, n_model), batch, max_len in {cache_cases!r}:
                mesh = make_mesh(data, n_model)
                shapes = jax.eval_shape(lambda: model.init_caches(batch,
                                                                  max_len))
                key = f"{{arch}}|{{smoke}}|{{data}}x{{n_model}}|{{batch}}|{{max_len}}"
                try:
                    tree = cache_shardings(mesh, shapes, batch)
                except ValueError as e:
                    specs[key] = {{"error": str(e)}}
                    continue
                flat = jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
                specs[key] = {{"/".join(str(k.key) for k in path):
                              [e if isinstance(e, (str, type(None)))
                               else list(e) for e in s.spec]
                              for path, s in flat}}
    json.dump(specs, open(f"{{out}}/jax/cache_specs.json", "w"))
    print("JAX_MODEL_AXIS_DONE")
"""


def _start_jax(out: str) -> subprocess.Popen:
    """The JAX runs in a subprocess on 4 forced host devices."""
    body = JAX_SCRIPT.format(
        out=out, kw=KW, archs=ARCHS, steps=STEPS, serve_arch=SERVE_ARCH,
        serve_worlds=SERVE_WORLDS, max_len=MAX_LEN, new=NEW, dense=DENSE,
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


def _cfg(arch):
    return get_config(arch, smoke=True).variant(dtype="float32")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's inputs, then the JAX subprocess beside the two gloo
    worlds; returns (out, {world: per-rank results})."""
    out = str(tmp_path_factory.mktemp("model_axis"))
    for arch in ARCHS:
        Trainer(_cfg(arch), 2, device="cpu", **KW).save_checkpoint(
            os.path.join(out, "init", arch))
    cfg = _cfg(SERVE_ARCH)
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(1))
    save_checkpoint(os.path.join(out, "serve", "params"), params)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, (4, PROMPT))
    np.save(os.path.join(out, "serve", "prompts.npy"), prompts)
    jax_proc = _start_jax(out)
    serve = dict(arch=SERVE_ARCH, params=os.path.join(out, "serve",
                                                      "params"),
                 prompts=os.path.join(out, "serve", "prompts.npy"),
                 max_len=MAX_LEN, steps=NEW)
    train_runs = {name: dict(arch=arch, init=os.path.join(out, "init", arch),
                             trainer_kw=KW, steps=STEPS, fault=fault)
                  for name, (arch, fault) in RUNS.items()}
    ranks = {}
    try:
        for data, n_model in SERVE_WORLDS:
            ranks[(data, n_model)] = rank_runs.spawn(
                "model_axis", data * n_model,
                os.path.join(out, f"ranks_{data}x{n_model}"), data=data,
                model=n_model, serve=serve,
                runs=train_runs if data == 2 else {})
        stdout, stderr = jax_proc.communicate(timeout=600)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
    assert jax_proc.returncode == 0 and "JAX_MODEL_AXIS_DONE" in stdout, \
        stderr[-3000:]
    return out, ranks


# ---------------------------------------------------------------------------
# The spec tables
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(set(_ALIASES)))
def test_spec_for_param_equals_the_reference(arch):
    """Every leaf of the config's params, at both sizes: the port's spec
    tuple is the reference's ``PartitionSpec`` as a tuple; ``tree_specs``
    is ``spec_for_param`` leaf by leaf; ``shard_rules`` raises as the
    reference's does."""
    for smoke in (True, False):
        cfg = get_config(arch, smoke=smoke)
        specs = PARAM_SPECS[cfg.family](cfg)
        got = cm.tree_specs(specs)
        n = 0

        def check(path, leaf):
            nonlocal n
            want = tuple(jcm.spec_for_param(path, tuple(leaf.shape)))
            assert cm.spec_for_param(path, tuple(leaf.shape)) == want, path
            node = got
            for k in path.split("/"):
                node = node[k]
            assert node == want, path
            n += 1
        cm.map_with_path(check, specs)
        assert n == len(tr.tree_leaves(specs))
    for fn in (cm.shard_rules, jcm.shard_rules):
        with pytest.raises(NotImplementedError, match="spec_for_param"):
            fn({})


def test_cache_shardings_dp_entries_equal_the_reference(runs):
    """The dense configs' caches (smoke and full) on each mesh and batch:
    the port's dp entries are the reference's, and where the reference
    raises the port raises the same ``ValueError``; the model entry sits
    on the KV-head dim where the heads divide."""
    out, _ = runs
    want = json.load(open(os.path.join(out, "jax", "cache_specs.json")))
    checked = raised = 0
    for arch in DENSE:
        for smoke in (True, False):
            cfg = get_config(arch, smoke=smoke)
            for (data, n_model), batch, max_len in CACHE_CASES:
                key = f"{arch}|{smoke}|{data}x{n_model}|{batch}|{max_len}"
                shapes = tfm.init_caches(cfg, batch, max_len, "meta")
                mesh = {"data": data, "model": n_model}
                if "error" in want[key]:
                    with pytest.raises(ValueError) as e:
                        cache_shardings(mesh, shapes, batch)
                    assert str(e.value) == want[key]["error"]
                    raised += 1
                    continue
                got = cache_shardings(mesh, shapes, batch)
                for path, w in want[key].items():
                    node = got
                    for k in path.split("/"):
                        node = node[k]
                    w = [None if e == "model" else e for e in w]
                    w += [None] * (len(node) - len(w))
                    assert [None if e == "model" else e for e in node] == w
                    kh = node[-2]
                    assert (kh == "model") == (cfg.n_kv_heads % n_model == 0
                                               and cfg.n_kv_heads >= n_model)
                    checked += 1
    assert checked and raised


def test_placement_rule():
    """A dim splits only into whole heads or evenly; else the leaf is held
    whole (4 KV heads on a 16-way axis); slices join back bit for bit."""
    assert cm.model_slice((None, "model"), (2048, 256), 16, heads=4) is None
    assert cm.model_slice((None, "model"), (2048, 256), 4, heads=4) == 1
    assert cm.model_slice(("model", None), (100, 8), 3) is None
    assert cm.model_slice((None, None), (4, 4), 2) is None
    cfg = _cfg("tinyllama-1.1b")
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    dims = cm.placement(cfg, params, 4)
    assert dims["blocks"]["global"]["attn"]["wq"] == 2
    assert dims["blocks"]["global"]["attn"]["wk"] is None     # KH 2 < 4
    assert dims["blocks"]["global"]["mlp"]["w2"] == 1
    assert dims["lm_head"] == 0 and dims["ln_f"]["scale"] is None
    parts = [cm.take_slices(params, dims, cm.ModelWorld(4, m))
             for m in range(4)]
    for a, b in zip(tr.tree_leaves(cm.join_slices(parts, dims)),
                    tr.tree_leaves(params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("heads,kv,n_model", [(4, 2, 2), (4, 2, 4),
                                               (6, 2, 3), (36, 4, 3)])
def test_each_rank_attends_with_its_own_heads(heads, kv, n_model):
    """Every rank's q heads over the KV heads ``kv_of_rank`` gives them
    (its slice where the KV heads split, else the run its heads read, or
    one head a q head where that run is uneven: 36 heads over 4 KV heads
    on 3 ranks) are the whole attention's heads of that rank."""
    cfg = _cfg("tinyllama-1.1b").variant(n_heads=heads, n_kv_heads=kv,
                                         d_model=16 * heads)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 8, heads, 16, generator=g)
    k, v = (torch.randn(1, 8, kv, 16, generator=g) for _ in range(2))
    whole = cm.differentiable_blocked_attention(q, k, v)
    hl = heads // n_model
    for m in range(n_model):
        mw = cm.ModelWorld(n_model, m)
        held = tfm.kv_heads_held(cfg, mw)
        lo = m * held if held < kv else 0
        kq, vq = tfm.kv_of_rank(cfg, k[:, :, lo:lo + held],
                                v[:, :, lo:lo + held], mw)
        got = cm.differentiable_blocked_attention(
            q[:, :, m * hl:(m + 1) * hl], kq, vq)
        torch.testing.assert_close(got, whole[:, :, m * hl:(m + 1) * hl])


@pytest.mark.parametrize("arch", ["xlstm-350m", "kimi-k2-1t-a32b"])
def test_other_families_refuse_a_model_world_naming_slice_4c(arch):
    """Slice 4c's third part gave these families the model axis, so they
    take a model world now; the one refusal left is an xLSTM split that
    would cut a head (the smoke config's 2 heads over 4 ranks)."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, "cpu", model_world=cm.ModelWorld(2, 0))
    assert model.model_world == cm.ModelWorld(2, 0)
    if cfg.family == "ssm":
        with pytest.raises(ValueError, match="heads do not divide"):
            build_model(cfg, "cpu", model_world=cm.ModelWorld(4, 0))


# ---------------------------------------------------------------------------
# Training against the JAX Trainer
# ---------------------------------------------------------------------------

def _template(cfg):
    return rank_runs.state_template(cfg, 2, {})


def _parting(out, ranks, name, arch) -> list:
    """What parts run ``name``'s ranks from the JAX run of ``arch``: the
    losses beyond 1e-6 relative, the step, phase or count, and every
    gathered leaf beyond 1e-5 of the leaf's largest magnitude; empty where
    they agree."""
    cfg = _cfg(arch)
    want_losses = np.load(os.path.join(out, "jax", arch, "losses.npy"))
    bad = []
    for r in ranks:
        if not np.allclose(r[f"{name}/losses"], want_losses,
                           rtol=LOSS_RTOL, atol=0):
            bad.append(("losses", r[f"{name}/losses"], want_losses))
        if float(r[f"{name}/skipped"]):
            bad.append("skipped")
    got = load_replica_state(os.path.join(out, "ranks_2x2", name),
                             _template(cfg))
    want = load_replica_state(os.path.join(out, "jax", arch), _template(cfg))
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


@pytest.mark.parametrize("arch", ARCHS)
def test_data2_model2_trainer_matches_jax_trainer(runs, arch):
    out, ranks = runs
    ranks = ranks[(2, 2)]
    assert _parting(out, ranks, arch, arch) == []
    for r in range(4):
        # the leaves held whole: bit-identical over each model group
        assert np.array_equal(ranks[r][f"{arch}/whole"],
                              ranks[r - r % 2][f"{arch}/whole"])
        # the gathered checkpoint restores at model 2 bit for bit
        assert bool(ranks[r][f"{arch}/restored"])


@pytest.mark.parametrize("name", ["no_f_backward", "q_norm_unsummed"])
def test_planted_faults_fail_the_jax_comparison(runs, name):
    out, ranks = runs
    arch = RUNS[name][0]
    assert _parting(out, ranks[(2, 2)], name, arch) != []


def test_model2_checkpoint_is_the_model1_checkpoint(runs, tmp_path):
    """The model-2 run's checkpoint holds the arrays, checksums and
    manifest a model-1 run writes of the same gathered state, and the
    model-1 Trainer restores it bit for bit."""
    out, _ = runs
    cfg = _cfg(ARCHS[0])
    src = os.path.join(out, "ranks_2x2", ARCHS[0])
    state = load_replica_state(src, _template(cfg))
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
def test_serving_matches_jax_serve_step(runs, world):
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
