"""Rehearsal on the CPU, at smoke size, of chip_smoke.py's attn model
phase: whisper-medium, internvl2-2b and transformer-wmt served over data
1 x model 2 gloo ranks under torchrun against rank 0 serving each whole,
then the paged scheduler over the same ranks against the dense
model-world runs, and the disaggregated scheduler over them against the
paged run, with the phase's planted faults.  The test's own process stays
on one torch thread."""

from smoke_rehearsal import load_chip_smoke as _chip_smoke
from smoke_rehearsal import one_torch_thread  # noqa: F401


def test_chip_smoke_attn_model_phase_at_smoke_size_on_cpu(tmp_path):
    """Checks (b)-(f) hold at smoke size: each family model's gathered
    logits and tokens are the one-rank run's, and not with the
    cross-attention's g left out; the scheduler preempts, its ranks agree
    on tokens, admissions, preemptions and shapes, each request holds to
    its dense model-world run, and the rank-local pick fails that; (g) the
    disaggregated scheduler over the ranks gives the paged run's tokens
    and schedule, each rank shipping its KV heads' bytes, and a bit
    flipped on rank 1's wire fails that; no pinned buffer is left off the
    card (nothing is staged); every logit finite.  No kernel launches off
    the card, so check (a) refuses the CPU run."""
    import pytest
    from repro_torch.serve.kv_transfer import kv_payload_bytes

    smoke = _chip_smoke()
    spec = smoke.attn_model_spec(
        device="cpu", smoke=True, new=4,
        prompts={"whisper-medium": 4, "internvl2-2b": 8,
                 "transformer-wmt": 8},
        src_len=12, sched_prompt=(8, 40), sched_new=6, block_size=4,
        max_blocks=16)
    stats = smoke.attn_model_phase(spec, tmp_path / "attn_model",
                                   timeout=240)
    fam = stats["families"]
    assert sorted(fam) == sorted(smoke.ATTN_MODEL_ARCHS)
    for arch, f in fam.items():
        e = f["serve_check"]
        assert e["ok"] and e["tokens_compared"] > 0, arch
        assert 0 < e["largest_logit"] < 1e3, arch    # no padding column
        assert [r["rank"] for r in f["ranks"]] == [0, 1]
        assert f["finite"] and f["in_vocab"]
    assert fam["transformer-wmt"]["cross_without_g_check"]["ok"] is False
    s = stats["sched"]
    assert s["ok"] and s["ranks_equal"] and s["evictions"] >= 1
    assert len(set(s["prompt_lens"])) == smoke.SCHED_REQUESTS
    assert s["fault_fails"]
    g = s["disagg"]
    assert g["ok"] and g["flip_fails"]
    assert [r["rank"] for r in g["ranks"]] == [0, 1]
    for r in g["ranks"]:
        assert r["equal_to_colocated"] and r["transfer"]["requests"] >= \
            smoke.SCHED_REQUESTS + 1             # a preemption ships again
        assert 2 * r["bytes_a_block"] == kv_payload_bytes(
            smoke.attn_model_cfg(spec, spec["sched_arch"]), 4)
        assert set(r["staging_ms"]) == {"d2h", "connector", "h2d"}
    assert all(h["buffers"] == 0 for h in stats["host"])
    with pytest.raises(AssertionError, match="launches"):
        smoke.check_attn_model_launches(stats)


def test_chip_smoke_predicts_the_attn_model_launches():
    """Check (a)'s counts at the card's sizes: K3 72 a whisper-medium
    prefill (24 encoder, 24 decoder, 24 cross), 24 an internvl2-2b one, 18
    a transformer-wmt one; the scheduler's tinyllama prefill 6 (its
    served depth); its
    requests of distinct lengths; the K3 kernel phase holds each rank
    shape the phase runs, both dtypes."""
    smoke = _chip_smoke()
    spec = smoke.attn_model_spec(sched_layers=smoke.SCHED_LAYERS)
    want = {"whisper-medium": 72, "internvl2-2b": 24, "transformer-wmt": 18}
    for arch, n in want.items():
        assert smoke.k3_per_prefill(smoke.attn_model_cfg(spec, arch)) == n
    cfg = smoke.attn_model_cfg(spec, spec["sched_arch"], spec["sched_layers"])
    assert smoke.k3_per_prefill(cfg) == 6
    lens = smoke.sched_lengths()
    assert len(set(lens)) == smoke.SCHED_REQUESTS
    assert all(64 <= n <= 512 for n in lens)
    shapes = [c[:8] for c in smoke.FAMILY_ATTN_CASES]
    for c in (list(smoke.WHISPER_RANK_ROLES.values())
              + list(smoke.WMT_RANK_ROLES.values())
              + [smoke.VLM_RANK_ATTN, smoke.SCHED_RANK_ATTN]):
        assert shapes.count(c) == 2, c
