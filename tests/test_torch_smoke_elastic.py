"""Rehearsals on the CPU, at smoke size, of chip_smoke.py's elastic phase."""

from smoke_rehearsal import NO_LAUNCHES, load_chip_smoke as _chip_smoke


def test_chip_smoke_elastic_phase_at_smoke_size_on_cpu():
    """chip_smoke's elastic phase rehearsed on the CPU at smoke size: the
    chaos schedule (worlds 8, 4, 8, 4, 8), the kill script (4, 2, 4) and
    the replay; checks (b)-(f) hold, (f)'s planted faults fail as they
    must, and no kernel launches off the card, so checks (a) and (g)
    refuse the CPU run."""
    import pytest
    import torch

    from repro_torch.configs import get_config

    smoke = _chip_smoke()
    cfg = get_config(smoke.ARCH, smoke=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stats = smoke.elastic_phase(cfg, device="cpu", seq_len=16)
    finally:
        torch.set_num_threads(threads)
    runs = stats["runs"]
    worlds = lambda run: [r["world"] for r in run["records"]]
    assert worlds(runs["chaos"]) == worlds(runs["replay"]) == \
        [8] * 4 + [4] * 4 + [8] * 2 + [4] * 2
    assert worlds(runs["kill"]) == [4, 4, 2, 2, 4, 4, 4, 4]
    assert [e["kind"] for e in runs["chaos"]["epoch_log"]] == \
        ["shrink", "regrow"] * 2
    assert all(t["rows_taken"] for run in runs.values()
               for t in run["transitions"])
    assert all(t["rows_identical"] for run in runs.values()
               for t in run["transitions"] if t["kind"] == "regrow")
    assert runs["kill"]["planted"] == {"regrow_off_barrier_raises": True}
    assert [t["planted_joiner_fails"] for t in runs["kill"]["transitions"]
            if t["kind"] == "regrow"] == [True]
    assert all(stats["replayed"].values())
    assert runs["replay"]["state_equal"] is True
    assert runs["chaos"]["launches"] == NO_LAUNCHES
    summary = smoke.elastic_summary(stats)
    assert set(summary["step_ms_by_world"]["chaos"]) == {4, 8}
    assert [t["transition_ms"] > 0 for t in summary["transitions"]] \
        == [True] * 10
    assert {w for run in runs.values() for w in run["combines"]} == \
        set(smoke.ELASTIC_WORLDS)
    assert summary["k1_k2_by_epoch"]["chaos epoch 0"] == [0, 0]
    # the operands the K1/K2 phase holds are the plans the runs compiled
    held = {w: {"combines": c} for w, c in smoke.elastic_combines(cfg).items()}
    smoke.check_elastic_held(stats, held)
    for w in held:
        with pytest.raises(AssertionError, match="check \\(a\\)"):
            smoke.check_elastic_held(stats, {v: c for v, c in held.items()
                                             if v != w})
    with pytest.raises(AssertionError, match="check \\(a\\)"):
        smoke.check_elastic_launches(stats)
    with pytest.raises(AssertionError, match="check \\(g\\)"):
        smoke.check_elastic_memory(stats)


def test_chip_smoke_elastic_check_b_fails_on_a_wrong_row(monkeypatch):
    """Check (b) can fail: a row selection that seats the survivors one
    row off must stop the phase at its first shrink."""
    import pytest
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import elastic as ce

    smoke = _chip_smoke()
    select = ce.select_replica_rows
    monkeypatch.setattr(ce, "select_replica_rows", lambda state, rows: select(
        state, [(r + 1) % len(rows) for r in rows]))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.raises(AssertionError, match="check \\(b\\)"):
            smoke.elastic_phase(get_config(smoke.ARCH, smoke=True),
                                device="cpu", seq_len=16)
    finally:
        torch.set_num_threads(threads)


def test_chip_smoke_elastic_check_e_fails_on_a_flipped_bit():
    """Check (e) compares the replay's final state with the first run's on
    the device: a copy of the same state is equal, and one bit flipped in
    one param element makes it differ."""
    import torch

    from repro_torch.configs import get_config

    smoke = _chip_smoke()
    cfg = get_config(smoke.ARCH, smoke=True)
    first = smoke.elastic_trainer(cfg, 2, "cpu", 16, keep=True)
    first.state_digest()
    kept = first.kept
    same = smoke.elastic_trainer(cfg, 2, "cpu", 16, against=kept)
    same.state_digest()
    assert same.state_equal is True
    flipped = [a.clone() for a in kept]
    flipped[0].view(-1).view(torch.uint8)[:1] ^= 1
    other = smoke.elastic_trainer(cfg, 2, "cpu", 16, against=flipped)
    other.state_digest()
    assert other.state_equal is False
