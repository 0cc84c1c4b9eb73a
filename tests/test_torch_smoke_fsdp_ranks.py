"""Rehearsal on the CPU, at smoke size, of chip_smoke.py's fsdp ranks
phase: gather-all FSDP over data 2 x pod 4 gloo ranks started by
torchrun, with checks (b)-(e), both planted faults (the swapped join of
check (c) and the guard without the pod MIN of check (e)), and no kernel
launched off the card, so that check (a) refuses the CPU run; then its
streamed ranks part on the same ranks (the layer-streamed engine, checks
(b)-(e), the planted mispaired gathers of check (d)).  The budget is
pinned (``SMOKE_BUCKET``) so that a group step has several shard
buckets.  Its one-process twin runs in this process, on one torch
thread."""

import pytest

from smoke_rehearsal import NO_LAUNCHES
from smoke_rehearsal import has_cuda as _has_cuda
from smoke_rehearsal import load_chip_smoke as _chip_smoke
# the rehearsal's one-process twin runs in this process
from smoke_rehearsal import one_torch_thread  # noqa: F401

# bytes: a smoke model's shard layout in several buckets
SMOKE_BUCKET = 1 << 16


def test_chip_smoke_fsdp_ranks_phase_at_smoke_size_on_cpu(tmp_path):
    """Five steps over 8 gloo ranks (both offsets twice, the sync at t =
    4): (b) the ranks' average equals the one-process
    plan's on both offsets; (c) the gathered trees are the pods' rows and
    the joined reduce-scattered slices the one-process ``grad_shards``,
    the swapped join parting; (d) the ranks' checkpoint state is the
    one-process twin's final state bit for bit, every leaf its save's,
    and the twin's manifest names the same leaves; (e) finite, no
    skip, the planted NaN skipping its whole pod under the MIN and
    parting another pod's members without it, in one step.  No kernel
    launches off the card."""
    smoke = _chip_smoke()
    spec = smoke.fsdp_ranks_spec(device="cpu", smoke=True, n_layers=None,
                                 seq_len=16, global_batch=16,
                                 bucket_bytes=SMOKE_BUCKET)
    stats = smoke.fsdp_ranks_phase(spec, tmp_path / "fsdp_ranks",
                                   timeout=300)
    assert stats["n_buckets"] >= 2
    assert (stats["pods"], stats["pod_size"]) == (4, 2)
    assert stats["stacked_equals_wire"] == {"0": True, "1": True}
    log = stats["ranks"][0]["log"]
    assert [e["sync"] for e in log] == [False] * 4 + [True]
    assert [e["profiled"] for e in log] == [False] * 3 + [True, False]
    assert [r["rank"] for r in stats["ranks"]] == list(range(8))
    assert [r["pod"] for r in stats["ranks"]] == [0, 0, 1, 1, 2, 2, 3, 3]
    c = stats["check_c"]
    assert c["gathered_equal"] and c["grads_equal"]
    assert c["swapped_join_parts"] and c["buckets"] >= 2
    d = stats["check_d"]
    assert d["state_bit_identical"] and d["step_phase_equal"]
    assert d["manifest_names_the_leaves"]
    assert d["max_loss_rel_diff"] <= smoke.RANKS_LOSS_RTOL
    assert d["max_param_change"] > 0 and d["leaves"] > 0
    assert stats["check_e"] == {"pod_skipped_whole": True,
                                "without_min_members_part": True}
    s = stats["summary"]
    assert all(s["bytes_a_group_step"][p] > 0
               for p in ("gather", "scatter", "average"))
    assert s["sync_bytes"] > 0
    assert s["device_idle_share"] is None       # no card, no device time
    for r in stats["ranks"]:
        for e in r["log"]:
            assert {"flash_attention": e["k3"], "group_average_combine":
                    e["k1"], "group_average_combine_multi": e["k2"],
                    "rglru_scan": e["k4"]} == {
                        k: NO_LAUNCHES[k] for k in (
                            "flash_attention", "group_average_combine",
                            "group_average_combine_multi", "rglru_scan")}
    assert not (tmp_path / "fsdp_ranks" / "ckpt").exists()
    with pytest.raises(AssertionError, match="K1, K2, K3, K4"):
        smoke.check_fsdp_ranks_launches(stats)
    # the operands a rank reports are its plan's slices
    assert stats["ranks"][0]["combines"][0]
    _streamed_part_holds(smoke, stats["streamed"])


def _streamed_part_holds(smoke, st):
    """The streamed ranks part of the rehearsal: its keys, checks (b)-(e)
    holding, the planted mispaired gathers parting on every rank, and
    check (a) refusing a run without launches."""
    assert {"n_buckets", "expected_gathers", "peak_gathered_bound",
            "check_b", "check_c", "pairs", "state_equal", "check_e",
            "summary", "seconds", "ranks",
            "expected_k1_k2_per_group_step"} <= set(st)
    assert st["n_buckets"] > 4 and st["pod_size"] == 2
    b = st["check_b"]
    assert b["logs"] == 8 * 5 and b["gathers"] == [st["expected_gathers"]]
    assert b["span_gathers_live_max"] == 2
    assert b["scatters_in_flight_max"] == 2
    assert b["peak_gathered_bytes"] <= b["peak_bound"] \
        == st["peak_gathered_bound"] < st["full_gathered_bytes"]
    assert st["check_c"]["slices_equal"] and st["check_c"]["leaves"] > 0
    assert st["state_equal"] and st["state_leaves"] > 0
    assert [(p["serial_equal"], p["mispaired_parts"])
            for p in st["pairs"]] == [(True, True)] * 8
    assert st["check_e"] == {"finite": True, "skipped": 0}
    log = st["ranks"][0]["log"]
    assert [e["sync"] for e in log] == [False] * 4 + [True]
    s = st["summary"]
    assert s["gathers_a_group_step"] == st["expected_gathers"]
    assert all(s["bytes_a_group_step"][p] > 0
               for p in ("gather", "scatter", "average"))
    assert s["device_idle_share"] is None       # no card, no device time
    for r in st["ranks"]:
        assert all(e["k1"] == e["k2"] == e["k3"] == e["k4"] == 0
                   for e in r["log"])
    with pytest.raises(AssertionError, match="K1, K2, K3, K4"):
        smoke.check_fsdp_ranks_launches(st)


def test_chip_smoke_fsdp_ranks_checks_fail_on_their_faults():
    """Check (e)'s verdict on rank 0's gathered counts (pod 1 keeps the
    MIN, pod 2 runs the planted guard without it): pod 1 skipping one
    member only, pod 2's members in step, or another pod skipping, fails;
    and a rank whose combine operands are not those the K1/K2 phase held
    fails check (a)."""
    smoke = _chip_smoke()
    assert smoke.FSDP_RANKS_BAD_PODS == (1, 2)
    ok = [5, 5, 4, 4, 4, 5, 5, 5]
    assert smoke.check_fsdp_ranks_guard(ok) == {
        "pod_skipped_whole": True, "without_min_members_part": True}
    for bad in ([5, 5, 4, 5, 4, 5, 5, 5], [5, 5, 4, 4, 5, 5, 5, 5],
                [5, 5, 4, 4, 4, 5, 4, 4]):
        with pytest.raises(AssertionError, match="check \\(e\\)"):
            smoke.check_fsdp_ranks_guard(bad)
    stats = {"expected_k1_k2_per_group_step": (1, 0), "ranks": [
        {"rank": 0, "combines": [[[8, 0.5]], None],
         "log": [{"t": 0, "sync": False, "k1": 1, "k2": 0, "k3": 0,
                  "k4": 0}]}]}
    smoke.check_fsdp_ranks_launches(stats, {"combines": ([(8, 0.5)], None)})
    with pytest.raises(AssertionError, match="K1/K2 phase held"):
        smoke.check_fsdp_ranks_launches(stats,
                                        {"combines": ([(16, 0.5)], None)})


def test_chip_smoke_fsdp_ranks_phase_fails_when_a_rank_fails(tmp_path):
    """Ranks asked for a card on a machine without one raise (none
    carries on on the CPU), and torchrun's failure fails the phase."""
    smoke = _chip_smoke()
    spec = smoke.fsdp_ranks_spec(device="cuda", smoke=True, n_layers=None,
                                 seq_len=16, global_batch=16, steps=1)
    if _has_cuda():
        return
    with pytest.raises(AssertionError, match="no CUDA device"):
        smoke.fsdp_ranks_phase(spec, tmp_path / "fsdp_ranks", timeout=240)
