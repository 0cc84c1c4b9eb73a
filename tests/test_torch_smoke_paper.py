"""Rehearsals on the CPU, at smoke size, of chip_smoke.py's paper phase:
transformer-wmt under the seven averagers."""

from smoke_rehearsal import NO_LAUNCHES, load_chip_smoke as _chip_smoke


def test_chip_smoke_paper_phase_at_smoke_size_on_cpu():
    """chip_smoke's paper phase, rehearsed on the CPU with transformer-wmt's
    smoke config: every averager trains 4 steps at P = 4, S = 2, tau = 3
    (both phase offsets and a sync) with checks (b) and (c) holding, the
    gossip mixes equal to their CPU copies; check (b) runs once for each
    phase and fails the step of a phase whose check failed; check (a)
    takes the launches of the schedule and refuses a baseline that
    launches K1; Fig. 5's two runs and the serving phase's checks (b)-(d)
    hold, its K3 calls tally 6 a prefill by role, and with no kernel
    launched off the card check (a) refuses the CPU run."""
    import pytest
    import torch

    from repro_torch.configs import get_config

    smoke = _chip_smoke()
    cfg = get_config(smoke.PAPER_ARCH, smoke=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # thousands of tiny ops: threads only contend
    try:
        runs = {name: smoke.paper_train_run(
            cfg, name, device="cpu", steps=4, replicas=4, group_size=2,
            tau=3, seq_len=16, global_batch=8,
            profile=name in smoke.PAPER_PROFILED)
            for name in smoke.PAPER_AVERAGERS}
        fig5 = smoke.fig5_phase(cfg, device="cpu", replicas=4, group_size=2,
                                tau=3, steps=6, seq_len=16, rows=2)
        wmt = smoke.family_serve_phase(cfg, device="cpu", batch=2,
                                       src_len=12, prompt_len=5, new=4,
                                       f32_steps=3)
    finally:
        torch.set_num_threads(threads)
    for name, run in runs.items():
        assert [e["sync"] for e in run["steps"]] == \
            [False, False, name in ("wagma", "local_sgd"), False]
        assert all(e["k1"] == e["k2"] == e["k3"] == e["k4"] == 0
                   for e in run["steps"])
        assert (run["profile"] is not None) == (name in smoke.PAPER_PROFILED)
        assert len(run["losses"]) == 4
    for name, run in runs.items():
        # every phase a step ran checked once: WAGMA's fused average
        # against the per-leaf one, a gossip mix against the CPU's
        checked = name == "wagma" or name in smoke.GOSSIP
        assert run["phase_checks"] == ({p: True for p in range(
            run["n_phases"])} if checked else {})
    assert [runs[n]["n_phases"] for n in ("wagma",) + smoke.GOSSIP] == \
        [2, 1, 2, 2]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(smoke, "fused_equals_per_leaf",
                   lambda ref_plan, out, tree, offset: offset == 0)
        with pytest.raises(AssertionError, match="wagma step 1"):
            smoke.paper_train_run(cfg, "wagma", device="cpu", steps=2,
                                  replicas=4, group_size=2, tau=3,
                                  seq_len=16, global_batch=8)
    for name in smoke.PAPER_AVERAGERS:
        if name == "wagma":
            with pytest.raises(AssertionError, match="wagma step 0"):
                smoke.check_paper_launches(runs[name])
        else:
            smoke.check_paper_launches(runs[name])
    k1, k2 = runs["wagma"]["expected_k1_k2_per_group_step"]
    on_card = dict(runs["wagma"], steps=[
        dict(e, k1=0 if e["sync"] else k1, k2=0 if e["sync"] else k2)
        for e in runs["wagma"]["steps"]])
    smoke.check_paper_launches(on_card)
    leaked = dict(runs["sgp"], steps=[dict(e, k1=1)
                                      for e in runs["sgp"]["steps"]])
    with pytest.raises(AssertionError, match="sgp step 0"):
        smoke.check_paper_launches(leaked)
    assert set(fig5["runs"]) == {"wagma", "allreduce"}
    assert all(len(r["losses"]) == 6 for r in fig5["runs"].values())
    assert fig5["ratio"] > 0 and fig5["runs"]["wagma"]["stalled"] >= 0
    assert wmt["k3_roles"] == {"encoder": 2, "decoder": 2, "cross": 2}
    assert wmt["k3_role_launches"] == 0
    with pytest.raises(AssertionError, match="K3 by role"):
        smoke.check_encdec_roles(wmt, cfg)
    smoke.check_encdec_roles(dict(wmt, k3_role_launches=6), cfg)
    with pytest.raises(AssertionError, match="prefill"):
        smoke.check_rg_launches(wmt, 0, 6)
    smoke.check_rg_launches(dict(wmt, prefill_launches=dict(
        NO_LAUNCHES, flash_attention=6)), 0, 6)
    assert len(wmt["tokens"]) == 2 and len(wmt["tokens"][0]) == 4
    assert wmt["logits_max_abs_diff"] <= smoke.LOGIT_RTOL * \
        wmt["logits_max_abs"]
    assert wmt["float32_check"]["logits_max_abs_diff"] < smoke.RG_F32_TOL


def test_chip_smoke_paper_baselines_run_only_the_steps_their_checks_need():
    """WAGMA and local SGD run 10 steps (both offsets and the sync at
    t = 9); Allreduce-SGD and Eager-SGD 3; D-PSGD 2; SGP and AD-PSGD one a
    phase and one more (5 at P = 16)."""
    smoke = _chip_smoke()
    want = {"wagma": 10, "local_sgd": 10, "allreduce": 3, "eager_sgd": 3,
            "dpsgd": 2, "sgp": 5, "adpsgd": 5}
    assert {name: smoke.paper_steps(name, 4 if name in ("sgp", "adpsgd")
                                    else 1)
            for name in smoke.PAPER_AVERAGERS} == want


def test_chip_smoke_gossip_checks_run_on_a_thread():
    """The paper phase's gossip checks (b) on a thread (``GossipChecks``):
    D-PSGD's and SGP's steps pass on the check having been issued, and
    ``settle`` puts every phase's verdict (the CPU mix equal to the
    card's, here both on the CPU) in ``phase_checks``; a mix that parts
    from the run's fails ``settle`` on check (b)."""
    import pytest
    import torch

    from repro_torch.configs import get_config

    smoke = _chip_smoke()
    cfg = get_config(smoke.PAPER_ARCH, smoke=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        checks = smoke.GossipChecks()
        runs = {name: smoke.paper_train_run(
            cfg, name, device="cpu", steps=3, replicas=4, group_size=2,
            tau=3, seq_len=16, global_batch=8, checks=checks)
            for name in ("dpsgd", "sgp")}
        checks.settle(runs)
        assert {n: r["phase_checks"] for n, r in runs.items()} == \
            {"dpsgd": {0: True}, "sgp": {0: True, 1: True}}
        bad = smoke.GossipChecks()
        out = {"w": torch.ones(4, 3)}
        run = {"phase_checks": {0: bad.submit(
            lambda host, phase: {"w": host["w"] * 2}, out, 0, out)}}
        with pytest.raises(AssertionError, match="differs from the CPU"):
            bad.settle({"sgp": run})
    finally:
        torch.set_num_threads(threads)
