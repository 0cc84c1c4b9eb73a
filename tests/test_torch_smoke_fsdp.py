"""Rehearsals on the CPU, at smoke size, of chip_smoke.py's FSDP and
layer-streamed phases."""

from smoke_rehearsal import NO_LAUNCHES, load_chip_smoke as _chip_smoke


def _fsdp_phase(smoke, keep=None):
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return smoke.fsdp_phase(smoke.fsdp_config(smoke=True), device="cpu",
                                seq_len=16, global_batch=16, keep=keep)
    finally:
        torch.set_num_threads(threads)


_FSDP_RUN = {}


def _fsdp_run():
    """One rehearsal of the FSDP phase (its stats and what it keeps for
    the streamed phase), shared by the FSDP and streamed rehearsals."""
    if not _FSDP_RUN:
        smoke = _chip_smoke()
        kept = {}
        _FSDP_RUN.update(smoke=smoke, stats=_fsdp_phase(smoke, kept),
                         kept=kept)
    return _FSDP_RUN["smoke"], _FSDP_RUN["stats"], _FSDP_RUN["kept"]


def test_chip_smoke_fsdp_phase_at_smoke_size_on_cpu():
    """chip_smoke's FSDP phase rehearsed on the CPU at smoke size (4 pods
    of 2, 5 steps: the group steps at t = 0..3, the sync at t = 4): checks
    (b)-(e) and (g) hold, the planted one-ulp nudge fails (b), the run's
    combines are the ones ``fsdp_combines`` gives the K1/K2 phase, and no
    kernel launches off the card, so checks (a) and (f) refuse the CPU
    run.  It keeps pod 0's final canonical params and momentum and the
    consolidated weights for the streamed phase."""
    import pytest

    smoke, stats, kept = _fsdp_run()
    assert stats["checked"] == {0: True, 1: True, "pod_mean_grads": True}
    assert stats["planted_fails"] is True
    assert (stats["pods"], stats["pod_size"], stats["replicas"]) == (4, 2, 8)
    assert [e["sync"] for e in stats["steps"]] == [False] * 4 + [True]
    assert set(kept) == {"params", "momentum", "weights"}
    assert stats["grads_pass"] is None
    assert stats["conversions"]["round_trip"] and \
        stats["conversions"]["consolidated_equals_pods"]
    assert stats["launches"] == NO_LAUNCHES
    assert {k: v["n_prefills"] for k, v in stats["serving"].items()} == \
        {"consolidated": smoke.FSDP_REQUESTS, "pod 0": smoke.FSDP_REQUESTS}
    held = {"combines": smoke.fsdp_combines(smoke.fsdp_config(smoke=True))}
    smoke.check_fsdp_held(stats, held)
    with pytest.raises(AssertionError, match="check \\(a\\)"):
        smoke.check_fsdp_held(stats, {"combines": smoke.fsdp_combines(
            smoke.fsdp_config())})
    with pytest.raises(AssertionError, match="check \\(a\\)"):
        smoke.check_fsdp_launches(stats)
    with pytest.raises(AssertionError, match="check \\(f\\)"):
        smoke.check_fsdp_memory(stats)
    r = stats["reckoning"]
    assert r["peak"] == max(r["train_peak"], r["average_peak"])
    assert r["replicated_peak"] > r["average_peak"]


def test_chip_smoke_streamed_phase_at_smoke_size_on_cpu():
    """chip_smoke's streamed phase rehearsed on the CPU at smoke size after
    the FSDP rehearsal: checks (b)-(d) and (f) hold (the streamed grads
    equal the gather-all ones bit for bit, the planted one-ulp nudge fails
    (b), losses, final params and momentum and serving weights equal the
    FSDP run's), every pod's fwd+bwd reads ``expected_stream_gathers``
    buckets, the combines are those ``streamed_combines`` gives the K1/K2
    phase, and no kernel launches off the card, so checks (a) and (e)
    refuse the CPU run."""
    import pytest
    import torch

    smoke, fsdp, kept = _fsdp_run()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stats = smoke.streamed_phase(smoke.fsdp_config(smoke=True), fsdp,
                                     kept, device="cpu", seq_len=16,
                                     global_batch=16)
    finally:
        torch.set_num_threads(threads)
    assert all(stats["checked"].values()) and len(stats["checked"]) == 7
    assert stats["checked"]["planted_fails"] is True
    assert stats["losses"] == fsdp["losses"]
    assert stats["n_spans"] == smoke.fsdp_config(smoke=True).n_layers
    assert stats["n_buckets"] == stats["n_spans"] + 2
    assert [e["gathers_per_pod"] for e in stats["steps"]] == \
        [stats["expected_stream_gathers"]] * smoke.FSDP_STEPS
    assert stats["conversions"]["via_replicated"] and \
        stats["conversions"]["via_gather_all"]
    assert stats["launches"] == NO_LAUNCHES
    g = stats["gathered_bytes"]
    assert g["stream_peak"] < g["full"]
    r, f = stats["grads_pass_reckoning"], stats["fsdp_grads_pass_reckoning"]
    assert r["accumulator"] == f["accumulator"] and r["grads"] < f["grads"]
    cfg = smoke.fsdp_config(smoke=True)
    smoke.check_streamed_held(stats, {"combines": smoke.streamed_combines(
        cfg)})
    with pytest.raises(AssertionError, match="check \\(a\\)"):
        smoke.check_streamed_held(stats, {"combines": smoke.fsdp_combines(
            cfg)})
    with pytest.raises(AssertionError, match="check \\(a\\)"):
        smoke.check_streamed_launches(stats)
    with pytest.raises(AssertionError, match="check \\(e\\)"):
        smoke.check_streamed_memory(stats)


def test_chip_smoke_fsdp_check_b_fails_on_a_planted_ulp(monkeypatch):
    """Check (b) can fail: the sharded average of buffers one of whose
    pod rows is nudged by one ulp differs from the replicated twin of the
    unnudged rows, directly and when the phase's own average runs on the
    nudged buffers."""
    import pytest
    import torch

    from repro_torch.core import plan as plan_mod

    smoke = _chip_smoke()
    cfg = smoke.fsdp_config(smoke=True).variant(dtype="bfloat16")
    plan = smoke.fsdp_plan(cfg)
    rep = plan_mod.compile_plan(plan.eff_topology, plan.storage_struct,
                                plan_mod.AveragingConfig(group_size=2))
    gen = torch.Generator().manual_seed(0)
    pre = tuple(torch.randn(plan.P_eff, n, generator=gen).to(d)
                for n, d in zip(plan.shard_layout.bucket_sizes,
                                plan.shard_layout.bucket_dtypes))
    for off in plan.offsets:
        out = plan.average_offset(pre, off)
        assert smoke.sharded_average_matches(plan, rep, pre, out, off)
        nudged = smoke.planted_ulp(plan, pre, off)
        assert sum(int((a != b).sum()) for a, b in zip(nudged, pre)) == 1
        assert not smoke.sharded_average_matches(plan, rep, nudged, out, off)
    average = plan_mod.AveragingPlan._average_sharded
    monkeypatch.setattr(
        plan_mod.AveragingPlan, "_average_sharded",
        lambda self, shards, offset: average(
            self, smoke.planted_ulp(self, shards, offset), offset))
    with pytest.raises(AssertionError, match="check \\(b\\)"):
        _fsdp_phase(smoke)
