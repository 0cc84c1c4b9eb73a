"""Rehearsal on the CPU, at smoke size, of chip_smoke.py's ep model phase:
xlstm-350m split by its heads and llama4-maverick and kimi-k2 through the
expert-parallel moe served over data 1 x model 2 gloo ranks under
torchrun against rank 0 serving each whole, with the phase's planted
faults.  The test's own process stays on one torch thread."""

from smoke_rehearsal import load_chip_smoke as _chip_smoke
from smoke_rehearsal import one_torch_thread  # noqa: F401


def test_chip_smoke_ep_model_phase_at_smoke_size_on_cpu(tmp_path):
    """Checks (b)-(e) hold at smoke size: each model's gathered logits and
    tokens are the one-rank run's, nothing drops and the share of moe
    assignments routed to another expert than the one-rank run's is
    measured (bf16 sums over the ranks round otherwise, so a near tie of
    the router may flip); a moe layer's prefill makes
    one routed all-reduce a chunk and a decode step one; the rank reading
    rank 0's slot-map rows and the mLSTM reading the next rank's z
    columns fail (b); every logit finite.  No kernel launches off the
    card, so check (a) refuses the CPU run."""
    import pytest

    smoke = _chip_smoke()
    spec = smoke.ep_model_spec(
        device="cpu", smoke=True, new=4,
        prompts={smoke.XLSTM_ARCH: 8, smoke.MOE_ARCHS[0]: 16,
                 smoke.MOE_ARCHS[1]: 16})
    stats = smoke.ep_model_phase(spec, tmp_path / "ep_model", timeout=240)
    fam = stats["families"]
    assert sorted(fam) == sorted(smoke.EP_MODEL_ARCHS)
    for arch, f in fam.items():
        e = f["serve_check"]
        assert e["ok"] and e["tokens_compared"] > 0, arch
        assert [r["rank"] for r in f["ranks"]] == [0, 1]
        assert f["finite"] and f["in_vocab"]
        if f["family"] == "moe":
            assert 0.0 <= f["route_parting"] < 0.25, arch
            assert f["ranks"][0]["routed"][0] == f["n_chunks"] == 2
        else:
            assert f["route_parting"] is None and f["ranks"][0]["routed"] \
                == []
    for arch in spec["faults"]:
        assert fam[arch]["fault_check"]["ok"] is False, arch
    with pytest.raises(AssertionError, match="launches"):
        smoke.check_ep_model_launches(stats)


def test_chip_smoke_predicts_the_ep_model_launches():
    """Check (a)'s counts at the card's sizes: K3 2 a moe prefill (its two
    layers), none on xlstm's; the K3 kernel phase holds both moe rank
    shapes (half the heads and KV heads of each, one row of 512 tokens) in
    both dtypes."""
    smoke = _chip_smoke()
    spec = smoke.ep_model_spec()
    assert smoke.ep_model_cfg(spec, smoke.XLSTM_ARCH).n_layers == 24
    shapes = [c[:8] for c in smoke.FAMILY_ATTN_CASES]
    for arch, shape in ((smoke.MOE_ARCHS[0], smoke.LLAMA4_RANK_ATTN),
                        (smoke.MOE_ARCHS[1], smoke.KIMI_RANK_ATTN)):
        cfg = smoke.ep_model_cfg(spec, arch)
        assert cfg.n_layers == 2
        assert cfg.capacity_factor == cfg.n_experts / cfg.top_k
        assert shape == (1, spec["prompts"][arch], spec["prompts"][arch],
                         cfg.n_heads // smoke.MODEL_M,
                         cfg.n_kv_heads // smoke.MODEL_M, cfg.hd, True, None)
        assert shapes.count(shape) == 2, shape
