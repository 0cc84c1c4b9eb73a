"""The port's model axis for the ssm family (xlstm-350m: both blocks split
by their heads over the model ranks of each replica) against the JAX
package on Auto-typed ``(data, model)`` meshes (ROADMAP.md F1), on the
CPU in float32, at the smoke config (2 layers, 2 heads).

Two JAX subprocesses (training, serving; ``tests/model_axis_runs.py``)
and two gloo worlds run side by side, all from the same port-made inputs:

- training, world ``data 2 x model 2``: 3 WAGMA steps at S 2 and tau 2
  from one initial state against the JAX Trainer on a ``(2, 2)`` mesh:
  losses within 1e-6 relative, the gathered params and momenta within
  1e-5 of each leaf's largest magnitude; the leaves held whole (``wif``,
  ``bif``, ``bg``, ``r``, the norms) bit-identical over each model group;
  ``wif``'s gradient left partial (its ``copy_to_model`` left out) must
  fail the comparison;
- serving, worlds ``data 2 x model 2`` and ``data 1 x model 2``: prefill
  and 4 greedy decode steps against the reference's ``build_serve_step``
  with ``serve_param_shardings``/``cache_shardings``, logits within 1e-5
  and the tokens equal;
- placement: every leaf's split dim is the one the reference's sharding
  cuts (smoke at model 2, the published config at 2 and 4);
  ``cache_shardings``' dp entries for the recurrent states are the
  reference's, its model entry on their heads;
- init: a rank's init is ``take_slices`` of the whole init, bit for bit.
"""

import numpy as np
import pytest
import torch

import model_axis_runs as mar
from jax_trainer_runs import one_torch_thread  # noqa: F401

from repro_torch.configs import get_config
from repro_torch.core import tree as tr
from repro_torch.models import common as cm
from repro_torch.models import xlstm
from repro_torch.models.registry import build_model
from repro_torch.serve.decode import cache_shardings

ARCH = "xlstm-350m"
# name -> (arch, planted fault)
RUNS = {"train": (ARCH, None), "wif_unsummed": (ARCH, "wif_unsummed")}
# the (config, model ranks) the placement is held at: the smoke config's 2
# heads split over 2 ranks only
PLACEMENT_CASES = [(True, 2), (False, 2), (False, 4)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("xlstm_model_axis"))
    return out, mar.run_all(out, (ARCH,), RUNS)


@pytest.mark.parametrize("smoke,n_model", PLACEMENT_CASES)
def test_placement_is_the_reference_sharding(runs, smoke, n_model):
    """Every leaf the reference's ``serve_param_shardings`` cuts on a dim
    is one the port's ``placement`` splits on that dim, and every other
    leaf is held whole: ``w_up``, ``wq``/``wk``/``wv`` and ``wg`` by
    column, both ``w_down`` by row, ``emb`` by vocab; ``wif``, ``bif``,
    ``bg``, ``r`` and the norms whole."""
    out, _ = runs
    cfg = get_config(ARCH, smoke=smoke)
    want = mar.shard_shapes(out)[f"{ARCH}|{smoke}|{n_model}"]
    shapes = mar.flat(xlstm.param_shapes(cfg))
    dims = mar.flat(cm.placement(cfg, xlstm.param_shapes(cfg), n_model))
    assert sorted(shapes) == sorted(want)
    for path, shape in shapes.items():
        cut = [i for i, (a, b) in enumerate(zip(shape, want[path]))
               if a != b]
        assert dims[path] == (cut[0] if cut else None), (path, n_model)
    for name in ("wif", "bif", "bg", "r"):
        kind = "mlstm" if name in ("wif", "bif") else "slstm"
        assert dims[f"blocks/{kind}/{name}"] is None
    assert dims["blocks/mlstm/w_up"] == dims["blocks/slstm/wg"] == 2
    assert dims["blocks/mlstm/w_down"] == dims["blocks/slstm/w_down"] == 1


def test_cache_shardings_dp_entries_equal_the_reference(runs):
    """The mLSTM and sLSTM states (smoke and published) on each mesh and
    batch: the port's dp entries are the reference's, and where the
    reference raises the port raises the same ``ValueError``; the model
    entry sits on the heads (dim 2) where they divide."""
    out, _ = runs
    want = mar.cache_specs(out)
    checked = raised = 0
    for smoke in (True, False):
        cfg = get_config(ARCH, smoke=smoke)
        for (data, n_model), batch, max_len in mar.CACHE_CASES:
            key = f"{ARCH}|{smoke}|{data}x{n_model}|{batch}|{max_len}"
            shapes = xlstm.init_caches(cfg, batch, max_len, "meta")
            mesh = {"data": data, "model": n_model}
            if "error" in want[key]:
                with pytest.raises(ValueError) as e:
                    cache_shardings(mesh, shapes, batch)
                assert str(e.value) == want[key]["error"]
                raised += 1
                continue
            got = mar.flat(cache_shardings(mesh, shapes, batch))
            assert sorted(got) == sorted(want[key])
            for path, w in want[key].items():
                node = got[path]
                w = [None if e == "model" else e for e in w]
                w += [None] * (len(node) - len(w))
                assert [None if e == "model" else e for e in node] == w, \
                    (key, path)
                if node[2] != "data":
                    assert (node[2] == "model") == (
                        cfg.n_heads % n_model == 0
                        and cfg.n_heads >= n_model), (key, path)
                checked += 1
    assert checked and raised


def test_data2_model2_trainer_matches_jax_trainer(runs):
    """xlstm over data 2 x model 2 holds to the JAX Trainer; the leaves
    held whole are bit-identical over each model group, and the gathered
    checkpoint restores at model 2 bit for bit."""
    out, ranks = runs
    ranks = ranks[(2, 2)]
    assert mar.parting(out, ranks, "train", ARCH) == []
    mar.held_whole_and_restored(ranks, "train")


def test_wif_gradient_left_partial_fails_the_jax_comparison(runs):
    """Without ``copy_to_model`` on ``wif`` each rank updates it with its
    own heads' columns of the gradient only: the leaves held whole part
    over the model group and the gathered state parts from the JAX run."""
    out, ranks = runs
    ranks = ranks[(2, 2)]
    assert mar.parting(out, ranks, "wif_unsummed", ARCH) != []
    assert not np.array_equal(ranks[0]["wif_unsummed/whole"],
                              ranks[1]["wif_unsummed/whole"])


@pytest.mark.parametrize("world", mar.SERVE_WORLDS,
                         ids=[f"data{d}xmodel{m}" for d, m in
                              mar.SERVE_WORLDS])
def test_serving_matches_jax_serve_step(runs, world):
    out, ranks = runs
    mar.check_serving(out, ranks, ARCH, world)


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_sliced_init_equals_take_slices(rank):
    """A model rank draws every leaf as the whole init does and keeps its
    slice: ``take_slices`` of the whole init, bit for bit, dtypes too."""
    cfg = mar.smoke(ARCH)
    whole = build_model(cfg, "cpu").init(torch.Generator().manual_seed(5))
    mw = cm.ModelWorld(2, rank)
    got = build_model(cfg, "cpu", model_world=mw).init(
        torch.Generator().manual_seed(5))
    want = cm.take_slices(whole, cm.placement(cfg, whole, 2), mw)
    for a, b in zip(tr.tree_leaves(got), tr.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got["blocks"]["mlstm"]["w_up"].shape[-1] == \
        whole["blocks"]["mlstm"]["w_up"].shape[-1] // 2
