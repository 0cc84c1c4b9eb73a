"""Rehearsals on the CPU, at smoke size, of chip_smoke.py's family phase:
whisper-medium, internvl2-2b and xlstm-350m."""

from smoke_rehearsal import NO_LAUNCHES, load_chip_smoke as _chip_smoke


def _family_phase(arch, **kw):
    """chip_smoke's serving phase of ``arch``'s smoke config on the CPU,
    batch 2, 4 new tokens, check (c) over 3 decode steps."""
    import torch

    from repro_torch.configs import get_config

    smoke = _chip_smoke()
    cfg = get_config(arch, smoke=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # thousands of tiny ops: threads only contend
    try:
        run = smoke.family_serve_phase(cfg, device="cpu", batch=2, new=4,
                                       f32_steps=3, **kw)
    finally:
        torch.set_num_threads(threads)
    assert len(run["tokens"]) == 2 and len(run["tokens"][0]) == 4
    assert all(0 <= t < cfg.vocab for row in run["tokens"] for t in row)
    assert run["logits_max_abs_diff"] <= smoke.LOGIT_RTOL * \
        run["logits_max_abs"]
    assert run["float32_check"]["logits_max_abs_diff"] < smoke.RG_F32_TOL
    assert run["prefill_launches"] == NO_LAUNCHES
    assert run["step_launches"] == [NO_LAUNCHES] * 3
    assert set(run["profile"]) == {"prefill", "decode_step"}
    assert all(w["device_busy_ms"] is None for w in run["profile"].values())
    return smoke, cfg, run


def test_chip_smoke_whisper_phase_at_smoke_size_on_cpu():
    """chip_smoke's whisper-medium phase at smoke size on the CPU: checks
    (b)-(d) hold over the frame embeddings; K3's calls tally one a layer
    and role, and with no kernel launched off the card check (a) refuses
    the CPU run and takes the launches of the card."""
    import pytest

    smoke, cfg, run = _family_phase("whisper-medium", prompt_len=4)
    assert run["input_positions"] == cfg.encoder_frames + 4
    n = cfg.n_layers
    assert run["k3_roles"] == {"encoder": cfg.encoder_layers, "decoder": n,
                               "cross": n}
    with pytest.raises(AssertionError, match="prefill"):
        smoke.check_family_launches(run, cfg)
    k3 = cfg.encoder_layers + 2 * n
    on_card = dict(run, k3_role_launches=k3, prefill_launches=dict(
        NO_LAUNCHES, flash_attention=k3))
    smoke.check_family_launches(on_card, cfg)
    with pytest.raises(AssertionError, match="K3 by role"):
        smoke.check_family_launches(dict(on_card, k3_roles=dict(
            run["k3_roles"], cross=n - 1)), cfg)
    assert smoke.WHISPER_ATTN_ROLES["cross"][1:3] == (smoke.WHISPER_PROMPT,
                                                       1500)


def test_chip_smoke_internvl2_phase_at_smoke_size_on_cpu():
    """chip_smoke's internvl2-2b phase at smoke size on the CPU: the patches
    come before the prompt, so the decode steps run at positions after
    them (check (b) against a fresh prefill over the same patches, check
    (c) against the float32 forward); check (a) refuses the CPU run and
    takes K3 once a layer a prefill."""
    import pytest

    smoke, cfg, run = _family_phase("internvl2-2b", prompt_len=9)
    assert run["input_positions"] == cfg.n_patches + 9
    assert run["k3_roles"] is None
    with pytest.raises(AssertionError, match="prefill"):
        smoke.check_family_launches(run, cfg)
    smoke.check_family_launches(dict(run, prefill_launches=dict(
        NO_LAUNCHES, flash_attention=cfg.n_layers)), cfg)
    with pytest.raises(AssertionError, match="decode step 1"):
        smoke.check_family_launches(dict(
            run, prefill_launches=dict(NO_LAUNCHES,
                                       flash_attention=cfg.n_layers),
            step_launches=[NO_LAUNCHES, dict(NO_LAUNCHES, flash_attention=1),
                           NO_LAUNCHES]), cfg)
    assert smoke.VLM_ATTN[1] == 256 + smoke.VLM_PROMPT


def test_chip_smoke_xlstm_phase_at_smoke_size_on_cpu():
    """chip_smoke's xlstm-350m phase at smoke size on the CPU: checks
    (b)-(d) hold and check (a) takes a path that launches no kernel, and
    refuses one that does."""
    import pytest

    smoke, cfg, run = _family_phase("xlstm-350m", prompt_len=11,
                                    f32_prompt=7)
    assert run["float32_check"]["prompt_len"] == 7
    smoke.check_family_launches(run, cfg)
    with pytest.raises(AssertionError, match="prefill"):
        smoke.check_family_launches(dict(run, prefill_launches=dict(
            NO_LAUNCHES, flash_attention=1)), cfg)
