"""Rehearsals on the CPU, at smoke size, of chip_smoke.py's tinyllama
serving, profile, training and handoff phases."""

from smoke_rehearsal import NO_LAUNCHES, load_chip_smoke as _chip_smoke


def test_chip_smoke_phases_at_smoke_size_on_cpu():
    """chip_smoke's serving, training and profile phases, rehearsed on the
    CPU with the smoke config: every request finishes, the pool preempts,
    the paged path agrees with the dense one; the training phase's checks
    (b)-(d) hold over 6 steps (3 phases and a sync) with a bucket budget
    small enough for multi-pair K2 batches; and no kernel launches off the
    card, so check (a) refuses the CPU run."""
    import pytest
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import plan

    smoke = _chip_smoke()
    cfg = get_config(smoke.ARCH, smoke=True)
    topology = plan.Topology.flat(("data",), (smoke.TRAIN_P,), link=(
        plan.LinkClass("link", bucket_bytes=16 << 10)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # thousands of tiny ops: threads only contend
    try:
        model, params, _ = smoke.load_model(cfg, "cpu")
        stats = smoke.serve_phase(model, params, device="cpu")
        windows = smoke.profile_phase(model, params, device="cpu",
                                      decode_steps=1)
        train, trainer = smoke.train_phase(cfg, device="cpu", steps=6,
                                           seq_len=16, global_batch=16,
                                           topology=topology)
        windows["train"] = smoke.train_profile(trainer, 6, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert train["n_buckets"] >= 3 and train["fused_equals_per_leaf"]
    k1, k2 = train["expected_k1_k2_per_group_step"]
    assert k1 > 0 and k2 > 0
    assert [e["sync"] for e in train["steps"]] == [False] * 4 + [True, False]
    assert train["launches"] == NO_LAUNCHES
    with pytest.raises(AssertionError):
        smoke.check_train_launches(train)
    assert stats["evictions"] > 0 and stats["n_prefills"] > smoke.N_REQUESTS
    assert stats["launches"] == NO_LAUNCHES
    assert {tuple(s) for s in stats["decode_shapes"]} <= \
        {(b, smoke.MAX_BLOCKS_PER_REQ) for b in (1, 2, 4, 8)}
    assert [c["rid"] for c in stats["checks"]] == list(smoke.CHECKED_REQUESTS)
    assert all(w["device_busy_ms"] is None for w in windows.values())


def test_chip_smoke_handoff_phase_at_smoke_size_on_cpu():
    """chip_smoke's handoff phase rehearsed on the CPU at smoke size: (a)
    the disaggregated run (prefill on its own weight copy, the pool that
    preempts) gives the colocated tokens and ships what the prefills need;
    (d) the wire that flips one bit fails (a), and the same single request
    without the flip passes it; (c) right after the tau-sync the
    consolidated weights are row 0 bit for bit, and at the end, with the
    rows apart by group, they serve the same tokens through both
    schedulers.  No kernel launches off the card, so check (a)'s launch
    count refuses the CPU run."""
    import dataclasses

    import pytest
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import tree as tr
    from repro_torch.serve import DisaggregatedScheduler

    smoke = _chip_smoke()
    cfg = get_config(smoke.ARCH, smoke=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, params, _ = smoke.load_model(cfg, "cpu")
        colo = smoke.serve_phase(model, params, device="cpu")
        run, again, fault = smoke.handoff_phase(model, params, colo,
                                                device="cpu")
        smoke.print_handoff(colo, again, run, fault, "cpu")
        prompt = smoke.make_requests(cfg)[0]
        want, _ = smoke.serve_tokens(model, params, [prompt])
        got, sched = smoke.serve_tokens(
            model, params, [prompt], DisaggregatedScheduler,
            prefill_params=tr.tree_map(torch.clone, params))
        post_sync = {}
        train, trainer = smoke.train_phase(
            cfg, device="cpu", steps=6, seq_len=16, global_batch=16,
            on_step=lambda t, tr_: t == 4 and post_sync.update(
                smoke.check_post_sync_consolidation(tr_, t)))
        trained = smoke.trained_serving(trainer, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert run["tokens"] == colo["tokens"] == again["tokens"]
    assert again["transfer"] is None
    t = run["transfer"]
    assert t["requests"] == run["n_prefills"] > smoke.N_REQUESTS
    assert run["evictions"] > 0 and t["bytes_sent"] >= t["payload_bytes"]
    assert fault["error"].startswith("check (a)") and fault["bit"] == 14
    stats = dataclasses.asdict(sched.connector.stats)
    smoke.check_disaggregated(want, got, stats, [len(prompt)], cfg)
    with pytest.raises(AssertionError, match="check \\(a\\)"):
        smoke.check_disaggregated(want, [got[0][:-1] + [-1]], stats,
                                  [len(prompt)], cfg)
    with pytest.raises(AssertionError, match="check \\(a\\)"):
        smoke.check_disaggregated(want, got, stats,
                                  [len(prompt) + smoke.BLOCK_SIZE], cfg)
    assert post_sync["step"] == 4 and post_sync["leaves"] > 0
    assert trained["colocated"]["tokens"] == \
        trained["disaggregated"]["tokens"]
    assert trained["disaggregated"]["n_layers"] == cfg.n_layers
    assert train["launches"] == NO_LAUNCHES
    for r in (run, trained["colocated"], trained["disaggregated"]):
        assert r["launches"] == NO_LAUNCHES
        with pytest.raises(AssertionError, match="serving path"):
            smoke.check_serving_launches(r, cfg.n_layers)
    with pytest.raises(AssertionError, match="not a sync step"):
        smoke.check_post_sync_consolidation(trainer, 5)


def test_chip_smoke_predicts_the_slice_launches():
    """The full-size slice: 10 buckets of 64 MiB, two stages, so a group
    step launches K1 18 times and K2 once (the tail batch of the two last
    buckets' stage-1 combines)."""
    smoke = _chip_smoke()
    plan = smoke.slice_plan(smoke.train_config())
    assert plan.class_bucket_bytes == {0: 64 << 20}
    assert plan.class_layout(0).n_buckets == 10
    assert smoke.expected_combine_launches(10, 2) == (18, 1)
    assert [ks for _, ks in smoke.scale_groups(10, 2) if len(ks) > 1] == \
        [[8, 9]]
    assert smoke.expected_combine_launches(1, 2) == (2, 0)
