"""Rehearsals on the CPU, at smoke size, of chip_smoke.py's moe phase:
llama4-maverick and kimi-k2."""

import pytest

from smoke_rehearsal import NO_LAUNCHES, load_chip_smoke as _chip_smoke


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b",
                                  "kimi-k2-1t-a32b"])
def test_chip_smoke_moe_phase_at_smoke_size_on_cpu(arch):
    """chip_smoke's moe phase at smoke size on the CPU: the timed run at
    the config's capacity, check (b) at the drop-free factor, check (c) on
    a cut to 2 experts; check (b) fails loudly at a capacity that drops;
    check (a) refuses the CPU run and takes K3 once a layer a prefill."""
    import torch

    from repro_torch.configs import get_config

    smoke = _chip_smoke()
    cfg = get_config(arch, smoke=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)         # thousands of tiny ops: threads only contend
    try:
        run = smoke.moe_serve_phase(cfg, device="cpu", batch=2, prompt_len=9,
                                    new=4, f32_experts=2,
                                    f32_prompt=7, f32_steps=3)
    finally:
        torch.set_num_threads(threads)
    assert len(run["tokens"]) == 2 and len(run["tokens"][0]) == 4
    assert all(0 <= t < cfg.vocab for row in run["tokens"] for t in row)
    b = run["dropfree"]
    assert b["capacity_factor"] == smoke.MOE_DROPFREE_FACTOR
    assert run["logits_max_abs_diff"] <= smoke.LOGIT_RTOL * \
        run["logits_max_abs"]
    assert run["float32_check"]["n_experts"] == 2
    assert run["float32_check"]["logits_max_abs_diff"] < smoke.RG_F32_TOL
    assert run["decode_dropped_max"] == 0.0
    assert 0.0 <= run["prefill_dropped"] < 1.0
    assert run["prefill_launches"] == NO_LAUNCHES
    with pytest.raises(AssertionError, match="prefill"):
        smoke.check_family_launches(run, cfg)
    smoke.check_family_launches(dict(run, prefill_launches=dict(
        NO_LAUNCHES, flash_attention=cfg.n_layers)), cfg)
    # a capacity that drops fails check (b) by name
    with pytest.raises(AssertionError, match="dropped"):
        smoke.moe_dropfree_check(cfg, smoke.load_model(cfg, "cpu")[1],
                                 device="cpu", batch=2, prompt_len=9, new=4,
                                 capacity_factor=0.25)
    full = smoke.moe_config(arch)
    assert full.n_layers == smoke.MOE_LAYERS and full.d_model >= 5120
    assert (smoke.KIMI_ATTN[3:6] == (64, 8, 112)
            and smoke.LLAMA4_ATTN[3:6] == (40, 8, 128))
    assert {c + ("bfloat16",) for c in (smoke.KIMI_ATTN,
                                         smoke.LLAMA4_ATTN)} \
        <= smoke.FAULT_SHAPES
