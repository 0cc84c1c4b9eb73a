"""Rehearsal on the CPU, at smoke size, of chip_smoke.py's fsdp model
phase: FSDP under a model axis over pod 2 x data 2 x model 2 gloo ranks
started by torchrun, gather-all and then streamed, with checks (b)-(g),
their planted faults (the pod view pairing the other model coordinate,
the swapped join, the guard of the pod's MIN alone), and no kernel
launched off the card, so that check (a) refuses the CPU run.  The budget
is pinned (``SMOKE_BUCKET``) so that a group step has several shard
buckets.  Its one-process twin runs in this process, on one torch
thread."""

import pytest

from smoke_rehearsal import NO_LAUNCHES
from smoke_rehearsal import has_cuda as _has_cuda
from smoke_rehearsal import load_chip_smoke as _chip_smoke
# the rehearsal's one-process twin runs in this process
from smoke_rehearsal import one_torch_thread  # noqa: F401

# bytes: a smoke model's slice layout in several buckets
SMOKE_BUCKET = 1 << 15


def test_chip_smoke_fsdp_model_phase_at_smoke_size_on_cpu(tmp_path):
    """Five steps gather-all and five streamed over 8 gloo ranks (the
    sync at t = 4): (b) the pods equal at every coordinate, each model
    coordinate's one-process average equal to the ranks', the pod view at
    the other coordinate parting; (c) the leaves held whole equal over
    every model group; (d) pod 0's joined slices the one-process
    ``grad_shards`` at both coordinates, the swapped join parting; (e) the
    model-1 twin's losses within 1e-4 and its layout the gathered
    state's; (f) the streamed run's event logs, losses, final state and
    serial fwd+bwd the gather-all run's; (g) finite, no skip, the NaN
    skipping its whole pod and the pod's MIN alone parting a model
    group.  No kernel launches off the card."""
    smoke = _chip_smoke()
    spec = smoke.fsdp_model_spec(device="cpu", smoke=True, n_layers=None,
                                 seq_len=16, global_batch=8,
                                 bucket_bytes=SMOKE_BUCKET)
    stats = smoke.fsdp_model_phase(spec, tmp_path / "fsdp_model",
                                   timeout=300)
    st = stats.pop("streamed")
    assert (stats["pods"], stats["pod_size"]) == (2, 2)
    assert stats["n_buckets"] >= 2 and st["n_buckets"] > 2
    assert sum(stats["bucket_sizes"]) < sum(stats["whole_bucket_sizes"])
    assert [r["rank"] for r in stats["ranks"]] == list(range(8))
    assert [r["model_rank"] for r in stats["ranks"]] == [0, 1] * 4
    assert [r["pod"] for r in stats["ranks"]] == [0] * 4 + [1] * 4
    log = stats["ranks"][0]["log"]
    assert [e["sync"] for e in log] == [False] * 4 + [True]
    assert [e["profiled"] for e in log] == [False] * 3 + [True, False]
    for run in (stats, st):
        b = run["checks"]["b"]
        assert [v["offset"] for v in b] == [0]
        assert all(v["equal"] and v["other_coordinate_parts"] for v in b)
        assert len(run["checks"]["c"]) == 5 and min(run["checks"]["c"]) > 0
    d = stats["checks"]["d"]["by_model_rank"]
    assert [v["model_rank"] for v in d] == [0, 1]
    assert all(v["grads_equal"] and v["swapped_join_parts"]
               and v["buckets"] >= 2 for v in d)
    e = stats["check_e"]
    assert e["layout_is_the_twins"] and e["leaves"] > 0
    assert e["max_loss_rel_diff"] <= smoke.MODEL_LOSS_RTOL
    assert st["event_logs"] == 8 * 5 and st["span_gathers_live_max"] == 2
    assert st["state_equal"] and st["state_leaves"] > 0
    assert all(p["serial_equal"] for p in st["checks"]["pairs"])
    assert [x["loss"] for x in st["ranks"][0]["log"]] == \
        [x["loss"] for x in log]
    g = stats["check_g"]
    assert g["pod_skipped_whole"] and g["pod_min_only_parts"]
    for run in (stats, st):
        s = run["summary"]
        assert all(s["bytes_a_group_step"][p] > 0
                   for p in ("gather", "scatter", "average", "tp"))
        assert s["device_idle_share"] is None   # no card, no device time
        for r in run["ranks"]:
            for x in r["log"]:
                assert {"flash_attention": x["k3"], "group_average_combine":
                        x["k1"], "group_average_combine_multi": x["k2"],
                        "rglru_scan": x["k4"]} == {
                            k: NO_LAUNCHES[k] for k in (
                                "flash_attention", "group_average_combine",
                                "group_average_combine_multi",
                                "rglru_scan")}
        with pytest.raises(AssertionError, match="K1, K2, K3, K4"):
            smoke.check_fsdp_ranks_launches(run)
        assert run["ranks"][0]["combines"][0]


def test_chip_smoke_fsdp_model_checks_fail_on_their_faults():
    """Check (g)'s verdict on the counts by torch rank: pod 1 skipping on
    one model coordinate only under the guard, pod 0 skipping, or every
    model group in step under the pod's MIN alone, fails."""
    smoke = _chip_smoke()
    ok = {"guard": [5, 5, 5, 5, 4, 4, 4, 4],
          "pod_min_only": [5, 5, 5, 5, 5, 4, 5, 4]}
    assert smoke.check_fsdp_model_guard(ok)["pod_skipped_whole"]
    for name, bad in (("guard", [5, 5, 5, 5, 5, 4, 5, 4]),
                      ("guard", [4, 4, 5, 5, 4, 4, 4, 4]),
                      ("pod_min_only", [5, 5, 5, 5, 4, 4, 4, 4])):
        with pytest.raises(AssertionError, match="check \\(g\\)"):
            smoke.check_fsdp_model_guard(dict(ok, **{name: bad}))


def test_chip_smoke_fsdp_model_phase_fails_when_a_rank_fails(tmp_path):
    """Ranks asked for a card on a machine without one raise (none
    carries on on the CPU), and torchrun's failure fails the phase."""
    smoke = _chip_smoke()
    spec = smoke.fsdp_model_spec(device="cuda", smoke=True, n_layers=None,
                                 seq_len=16, global_batch=8, steps=1)
    if _has_cuda():
        return
    with pytest.raises(AssertionError, match="no CUDA device"):
        smoke.fsdp_model_phase(spec, tmp_path / "fsdp_model", timeout=240)
