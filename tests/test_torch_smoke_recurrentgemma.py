"""Rehearsals on the CPU, at smoke size, of chip_smoke.py's recurrentgemma
serving and training phases."""

from smoke_rehearsal import NO_LAUNCHES, load_chip_smoke as _chip_smoke


def test_chip_smoke_recurrentgemma_phase_at_smoke_size_on_cpu(monkeypatch):
    """chip_smoke's recurrentgemma phase, rehearsed on the CPU with the
    smoke config and a window of 16 tokens so that the ring wraps: checks
    (b)-(d) hold, the profile windows run, and with no kernel launched off
    the card check (a) refuses the CPU run."""
    import pytest

    from repro_torch.configs import get_config
    from repro_torch.models import rglru

    smoke = _chip_smoke()
    monkeypatch.setattr(rglru, "ATTN_WINDOW", 16)
    cfg = get_config(smoke.RG_ARCH, smoke=True)
    model, params, _ = smoke.load_model(cfg, "cpu")
    stats = smoke.rg_serve_phase(model, params, device="cpu", batch=2,
                                 prompt_len=21, new=4)
    windows = smoke.rg_profile(model, params, device="cpu", batch=2,
                               prompt_len=21)
    f32 = smoke.rg_f32_check(cfg, params, device="cpu", prompt_len=19,
                             steps=3)
    assert len(stats["tokens"]) == 2 and len(stats["tokens"][0]) == 4
    assert stats["logits_max_abs_diff"] <= smoke.LOGIT_RTOL * \
        stats["logits_max_abs"]
    assert f32["logits_max_abs_diff"] < smoke.RG_F32_TOL
    assert stats["prefill_launches"] == NO_LAUNCHES
    assert stats["step_launches"] == [NO_LAUNCHES] * 3
    n_sb, tail = rglru.layout(cfg)
    with pytest.raises(AssertionError, match="prefill"):
        smoke.check_rg_launches(stats, 2 * n_sb + tail, n_sb)
    on_card = dict(stats, prefill_launches=dict(NO_LAUNCHES, rglru_scan=2,
                                                rglru_scan_tma=2,
                                                flash_attention=1),
                   step_launches=[dict(NO_LAUNCHES, rglru_scan=2,
                                       rglru_scan_walk=2)] * 3)
    smoke.check_rg_launches(on_card, 2 * n_sb + tail, n_sb)
    # a prefill scan on the walk route, or a decode step on the TMA route,
    # fails check (a)
    walked = dict(on_card, prefill_launches=dict(
        on_card["prefill_launches"], rglru_scan_tma=1, rglru_scan_walk=1))
    with pytest.raises(AssertionError, match="prefill"):
        smoke.check_rg_launches(walked, 2 * n_sb + tail, n_sb)
    piped = dict(on_card, step_launches=on_card["step_launches"][:2] + [
        dict(NO_LAUNCHES, rglru_scan=2, rglru_scan_tma=2)])
    with pytest.raises(AssertionError, match="decode step 2"):
        smoke.check_rg_launches(piped, 2 * n_sb + tail, n_sb)
    assert all(w["device_busy_ms"] is None for w in windows.values())
    assert all(set(w["shares"]) == {"K4", "K3"} for w in windows.values())


def test_chip_smoke_rg_train_phase_at_smoke_size_on_cpu():
    """chip_smoke's recurrentgemma training phase, rehearsed on the CPU with
    the smoke config at the phase's 5 layers (a superblock and a tail), 4
    replicas, S = 2, 6 steps (both phase offsets and the sync at t = 4) and
    a bucket budget small enough for multi-pair K2 batches: its checks of
    the rows, the fused average and the losses hold; with no kernel
    launched off the card checks (a) and (b) refuse the CPU run; check (b)
    takes the launches the layout predicts and refuses a step with a
    walk-route or a missing scan."""
    import pytest
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import plan

    smoke = _chip_smoke()
    cfg = get_config(smoke.RG_ARCH, smoke=True).variant(
        n_layers=smoke.RG_TRAIN_LAYERS)
    topology = plan.Topology.flat(("data",), (smoke.RG_TRAIN_P,), link=(
        plan.LinkClass("link", bucket_bytes=16 << 10)))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # thousands of tiny ops: threads only contend
    try:
        train, trainer = smoke.train_phase(
            cfg, device="cpu", steps=6, seq_len=16, global_batch=8,
            topology=topology, replicas=smoke.RG_TRAIN_P,
            group_size=smoke.RG_TRAIN_S)
        window = smoke.train_profile(trainer, 6, device="cpu", shares={
            "K4": "rglru_scan"})
    finally:
        torch.set_num_threads(threads)
    assert train["fused_equals_per_leaf"] and train["n_buckets"] >= 3
    assert [e["sync"] for e in train["steps"]] == [False] * 4 + [True, False]
    assert train["launches"] == NO_LAUNCHES
    with pytest.raises(AssertionError):
        smoke.check_train_launches(train)
    k4 = smoke.rg_train_k4_per_step(cfg, smoke.RG_TRAIN_P)
    assert k4 == smoke.RG_TRAIN_P * (3 * 2 + 2 * 2)
    with pytest.raises(AssertionError, match="step 0"):
        smoke.check_rg_train_launches(train, k4)
    on_card = dict(train, steps=[dict(e, k4=k4, k4_tma=k4)
                                 for e in train["steps"]])
    smoke.check_rg_train_launches(on_card, k4)
    for bad in (dict(k4_tma=k4 - 1, k4_walk=1), dict(k4=k4 - 1,
                                                       k4_tma=k4 - 1)):
        steps = [dict(e) for e in on_card["steps"]]
        steps[3].update(bad)
        with pytest.raises(AssertionError, match="step 3"):
            smoke.check_rg_train_launches(dict(train, steps=steps), k4)
    assert window["device_busy_ms"] is None
    assert smoke.SCAN_TRAIN_SHAPE == (8, 512, 2560)
