"""Rehearsals on the CPU, at smoke size, of chip_smoke.py's rank phases:
the ranks phase (one replica a gloo rank), the model phase (the dense
family over data x model ranks) and the rg model phase (the hybrid
family over data x model ranks), each with its checks (g) and (h) of
the asynchronous wire (at a pinned bucket budget, ``SMOKE_BUCKET``, so
that a group step has several buckets in flight).  Each starts a
torchrun world; they
share one file so that one worker runs them one after another, since
gloo ranks of several worlds side by side contend for the cores.  Each
runs its stacked twin in this process, on one torch thread: under the
suite's parallel workers more threads only contend (the rg model twin
took 95 s instead of 2 under load)."""

import pytest

from smoke_rehearsal import has_cuda as _has_cuda
from smoke_rehearsal import load_chip_smoke as _chip_smoke
# each rehearsal's stacked twin runs in this process
from smoke_rehearsal import one_torch_thread  # noqa: F401

# bytes: a smoke model's plan in several buckets, so that receipts overlap
SMOKE_BUCKET = 1 << 18


def _assert_overlap(stats):
    """Checks (g) and (h) held: every group step of rank 0 logged its
    wavefronts with at least 2 receipts in flight, within the schedule's
    bound, its slots too; the serial and the asynchronous average agreed
    and the mispaired receipts parted from the stacked plan."""
    o = stats["overlap"]
    assert 2 <= o["in_flight_max"] <= o["bound"] and o["slots"] <= o["bound"]
    assert o["issued"] >= 2 and o["fault_parts"] and all(o["fault_parts"])
    for r in stats["ranks"]:
        assert r["check_h"]["equal"]
        for e in r["log"]:
            assert e["sync"] == (e["check_g"] is None)


def test_chip_smoke_ranks_phase_at_smoke_size_on_cpu(tmp_path):
    """chip_smoke's ranks phase rehearsed on the CPU at smoke size: four
    gloo ranks under torchrun, 6 steps (both offsets and a sync); checks
    (b)-(e) hold (the wire average equals the stacked plan's on both
    offsets, the checkpoint reloads to the gathered state, the stacked
    twin ends bit-identical after moving the params), and no kernel
    launches off the card, so check (a) refuses the CPU run."""
    import pytest

    smoke = _chip_smoke()
    spec = smoke.ranks_spec(device="cpu", smoke=True, n_layers=None,
                            seq_len=16, global_batch=8, steps=6,
                            bucket_bytes=SMOKE_BUCKET)
    stats = smoke.ranks_phase(spec, tmp_path / "ranks", timeout=240)
    assert stats["stacked_equals_wire"] == {"0": True, "1": True}
    _assert_overlap(stats)
    assert [e["sync"] for e in stats["ranks"][0]["log"]] == \
        [False] * 4 + [True, False]
    assert [r["rank"] for r in stats["ranks"]] == [0, 1, 2, 3]
    e = stats["check_e"]
    assert e["max_loss_rel_diff"] <= smoke.RANKS_LOSS_RTOL
    assert e["params_bit_identical"] and e["differing_elements"] == 0
    assert e["elements"] > 0 and e["max_param_change"] > 0
    s = stats["summary"]
    assert s["wire_bytes_a_group_step"] > 0
    assert s["device_idle_share"] is None        # no card, no device time
    assert not (tmp_path / "ranks" / "ckpt").exists()
    with pytest.raises(AssertionError, match="K1, K2, K3, K4"):
        smoke.check_ranks_launches(stats)


def test_chip_smoke_ranks_phase_fails_when_a_rank_fails(tmp_path):
    """Ranks asked for a card on a machine without one raise (none carries
    on on the CPU), and torchrun's failure fails the phase."""
    import pytest

    smoke = _chip_smoke()
    spec = smoke.ranks_spec(device="cuda", smoke=True, n_layers=None,
                            seq_len=16, global_batch=8, steps=1)
    if _has_cuda():
        return
    with pytest.raises(AssertionError, match="no CUDA device"):
        smoke.ranks_phase(spec, tmp_path / "ranks", timeout=240)


def test_chip_smoke_ranks_check_e_fails_on_a_skipped_average(tmp_path,
                                                             monkeypatch):
    """Check (e) can fail: a stacked twin in which one replica skips one
    group average (row 1 at step 2) parts from the correct ranks, and the
    phase fails on (e)."""
    import pytest

    smoke = _chip_smoke()
    make = smoke.ranks_trainer

    def faulty_twin(spec, world=None):
        trainer = make(spec, world)
        comm, calls = trainer.averager.comm, []

        def skip_row_1(tree, phase):
            calls.append(phase)
            own = [a[1].clone() for a in tr.tree_leaves(tree)]
            out = comm(tree, phase)
            if len(calls) == 3:             # step 2: row 1 keeps its own
                for a, b in zip(tr.tree_leaves(out), own):
                    a[1].copy_(b)
            return out
        trainer.averager.comm = skip_row_1
        return trainer

    from repro_torch.core import tree as tr
    monkeypatch.setattr(smoke, "ranks_trainer", faulty_twin)
    spec = smoke.ranks_spec(device="cpu", smoke=True, n_layers=None,
                            seq_len=16, global_batch=8, steps=6)
    with pytest.raises(AssertionError, match="check \\(e\\)"):
        smoke.ranks_phase(spec, tmp_path / "ranks", timeout=240)


def test_chip_smoke_model_phase_at_smoke_size_on_cpu(tmp_path):
    """chip_smoke's model phase rehearsed on the CPU at smoke size: eight
    gloo ranks under torchrun as data 4 x model 2 (model minor), 6 steps
    (both offsets and a sync); checks (b)-(f) hold: the wire average of
    each model coordinate's slices equals the stacked plan's on both
    offsets, the leaves held whole agree over every model group at every
    step and not after the step without f in one layer, the stacked twin's
    losses within the bound, the served tokens and logits the one-rank
    run's; no kernel launches off the card, so check (a) refuses the CPU
    run."""
    import pytest

    smoke = _chip_smoke()
    spec = smoke.model_spec(device="cpu", smoke=True, n_layers=None,
                            seq_len=16, global_batch=8, steps=6, prompt=16,
                            new=4, bucket_bytes=SMOKE_BUCKET)
    stats = smoke.model_phase(spec, tmp_path / "model", timeout=240)
    _assert_overlap(stats)
    assert stats["stacked_equals_wire"] == {"0": [True, True],
                                            "1": [True, True]}
    assert stats["check_c"] == [True] * 6 and stats["fault_check_c"] is False
    assert [e["sync"] for e in stats["ranks"][0]["log"]] == \
        [False] * 4 + [True, False]
    assert [(r["rank"], r["dp"], r["model"]) for r in stats["ranks"]] == \
        [(r, r // 2, r % 2) for r in range(8)]
    assert stats["check_d"]["max_loss_rel_diff"] <= smoke.MODEL_LOSS_RTOL
    e = stats["serve_check"]
    assert e["ok"] and e["tokens_compared"] > 0
    s = stats["summary"]
    assert s["tp_bytes_a_step"] > 0 and s["wire_bytes_a_group_step"] > 0
    assert s["device_idle_share"] is None        # no card, no device time
    smoke.check_model_held(stats, None)
    with pytest.raises(AssertionError, match="K1, K2, K3, K4"):
        smoke.check_model_launches(stats)


def test_chip_smoke_rg_model_phase_at_smoke_size_on_cpu(tmp_path):
    """chip_smoke's rg model phase rehearsed on the CPU at smoke size: four
    gloo ranks under torchrun as data 2 x model 2 (model minor), 5 steps
    (group steps, then the sync); checks (b)-(f) hold: the wire average of
    each model coordinate's slices equals the stacked plan's, the leaves
    held whole (w_r, w_i, lam among them) agree over every model group at
    every step and not after the step whose first recurrent layer leaves
    w_r's gradient partial, the stacked twin's losses within the bound,
    the served tokens and logits the one-rank run's; no kernel launches
    off the card, so check (a) refuses the CPU run."""
    smoke = _chip_smoke()
    spec = smoke.rg_model_spec(device="cpu", smoke=True, n_layers=None,
                               seq_len=16, global_batch=4, steps=5,
                               prompt=16, new=4, bucket_bytes=SMOKE_BUCKET)
    stats = smoke.model_phase(spec, tmp_path / "rg_model", timeout=240)
    _assert_overlap(stats)
    assert stats["stacked_equals_wire"] == {"0": [True, True]}
    assert stats["check_c"] == [True] * 5 and stats["fault_check_c"] is False
    assert stats["fault_layer"] == 0
    assert [e["sync"] for e in stats["ranks"][0]["log"]] == \
        [False] * 4 + [True]
    assert [(r["rank"], r["dp"], r["model"]) for r in stats["ranks"]] == \
        [(r, r // 2, r % 2) for r in range(4)]
    assert stats["check_d"]["max_loss_rel_diff"] <= smoke.MODEL_LOSS_RTOL
    e = stats["serve_check"]
    assert e["ok"] and e["tokens_compared"] > 0
    s = stats["summary"]
    assert s["tp_bytes_a_step"] > 0 and s["wire_bytes_a_group_step"] > 0
    assert s["device_idle_share"] is None        # no card, no device time
    smoke.check_model_held(stats, None)
    with pytest.raises(AssertionError, match="K1, K2, K3, K4"):
        smoke.check_model_launches(stats)


def test_chip_smoke_predicts_the_rg_model_launches():
    """Check (a)'s counts at the card's sizes: a rank's training step
    scans K4 6 times (two recurrent layers under the superblock's
    recompute: forward, again, backward); a prefill at the served depth
    (6 layers: two superblocks) K4 4 times on the TMA route and K3 2
    times, a decode step K4 4 times on the walk route; a rank's plan over its 469,926,400 params holds 7 buckets,
    5 K1 and 1 K2 launches a group step."""
    smoke = _chip_smoke()
    cfg = smoke.rg_model_config()
    assert smoke.rg_train_k4_per_step(cfg, 1) == 6
    spec = smoke.rg_model_spec()
    pre, step = smoke.model_serve_launches(smoke.model_cfg(
        spec, smoke.RG_MODEL_SERVE_LAYERS))
    assert (pre[smoke.K4], pre[smoke.K4_TMA], pre[smoke.K3]) == (4, 4, 2)
    assert (step[smoke.K4], step[smoke.K4_WALK], step[smoke.K3]) == \
        (4, 4, 0)
    layout = smoke.model_slice_plan(cfg, smoke.RG_MODEL_DATA).class_layout(0)
    assert (layout.n_buckets, sum(layout.bucket_sizes)) == (7, 469926400)
    assert smoke.expected_combine_launches(layout.n_buckets, 1) == (5, 1)
