"""The port's heartbeat failure detector and staleness ledger
(``repro_torch/core/health.py``, ``core/staleness.SkipLedger``): the
host-side cases of tests/test_health.py against the port, and the
detector held to the JAX package's on seeded heartbeat traces (same
verdicts, same rounds, same flaps)."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import health as jax_health
from repro_torch.core import plan as plan_mod
from repro_torch.core import tree as tr
from repro_torch.core.elastic import MembershipController
from repro_torch.core.health import (ALIVE, DEAD, RECOVERED, SUSPECT,
                                     DetectorConfig, FailureDetector,
                                     Verdict)
from repro_torch.core.plan import AveragingConfig, Topology, compile_plan
from repro_torch.core.staleness import (SkipLedger, StalenessBoundExceeded,
                                        max_staleness_bound)

CFG = DetectorConfig(suspect_timeout_s=0.25, confirm_timeout_s=0.30,
                     backoff=2.0, max_backoff=8.0)


@pytest.mark.parametrize("kw", [
    dict(suspect_timeout_s=0.0), dict(suspect_timeout_s=-1.0),
    dict(confirm_timeout_s=0.0), dict(backoff=0.5),
])
def test_detector_config_rejects_bad_values(kw):
    with pytest.raises(ValueError):
        DetectorConfig(**kw)


# ---------------------------------------------------------------------------
# State machine: ALIVE -> SUSPECT -> DEAD, strict deadlines
# ---------------------------------------------------------------------------

def test_regular_heartbeats_keep_everyone_alive():
    det = FailureDetector(range(4), CFG)
    for t in range(10):
        now = t * 0.1
        for w in range(4):
            assert det.heartbeat(w, now) is None
        assert det.poll(now + 0.05) == []
    assert all(det.state(w) == ALIVE for w in range(4))


def test_suspect_fires_strictly_past_timeout():
    det = FailureDetector([0, 1], CFG)
    det.heartbeat(1, 0.1)
    assert det.poll(0.25) == []
    out = det.poll(0.26)
    assert [(v.worker, v.state) for v in out] == [(0, SUSPECT)]
    assert out[0].silent_s == pytest.approx(0.26)
    assert det.state(0) == SUSPECT and det.state(1) == ALIVE


def test_confirm_dead_after_further_silence_then_poll_goes_quiet():
    det = FailureDetector([0], CFG)
    (v,) = det.poll(0.30)
    assert v.state == SUSPECT and v.at == 0.30
    assert det.poll(0.60) == []
    (d,) = det.poll(0.61)
    assert d.state == DEAD and d.worker == 0
    assert det.state(0) == DEAD
    assert det.poll(5.0) == []


def test_poll_reports_multiple_workers_sorted():
    det = FailureDetector([3, 1, 0, 2], CFG)
    det.heartbeat(0, 0.2)
    out = det.poll(0.30)
    assert [v.worker for v in out] == [1, 2, 3]
    assert all(v.state == SUSPECT for v in out)


# ---------------------------------------------------------------------------
# Recovery, flaps, and the multiplicative backoff
# ---------------------------------------------------------------------------

def test_recovery_from_suspect_counts_a_flap_and_backs_off():
    det = FailureDetector([0], CFG)
    det.poll(0.30)
    assert det.state(0) == SUSPECT
    v = det.heartbeat(0, 0.35)
    assert isinstance(v, Verdict)
    assert v.state == RECOVERED and v.silent_s == pytest.approx(0.35)
    assert det.state(0) == ALIVE
    assert det.suspect_timeout(0) == pytest.approx(0.50)
    assert det.poll(0.35 + 0.50) == []
    (s,) = det.poll(0.35 + 0.51)
    assert s.state == SUSPECT


def test_rejoin_after_dead_is_a_recovery_too():
    det = FailureDetector([0], CFG)
    det.poll(0.30)
    det.poll(0.61)
    assert det.state(0) == DEAD
    v = det.heartbeat(0, 1.0)
    assert v.state == RECOVERED and det.state(0) == ALIVE


def test_backoff_is_capped_at_max_backoff():
    det = FailureDetector([0], CFG)
    for _ in range(6):
        det.poll(det.records[0].last_beat + det.suspect_timeout(0) + 0.01)
        det.heartbeat(0, det.records[0].suspected_at or 0.0)
    assert det.records[0].flaps == 6
    assert det.suspect_timeout(0) == pytest.approx(0.25 * 8.0)


def test_unseen_worker_announcing_itself_is_not_a_recovery():
    det = FailureDetector([0], CFG)
    assert det.heartbeat(7, 0.4) is None
    assert det.state(7) == ALIVE
    assert [(v.worker, v.state) for v in det.poll(0.45)] == [(0, SUSPECT)]


def test_verdicts_carry_the_detector_epoch():
    det = FailureDetector([0, 1], CFG, epoch=3)
    det.heartbeat(1, 0.2)
    (v,) = det.poll(0.30)
    assert v.worker == 0 and v.state == SUSPECT and v.epoch == 3
    det.set_epoch(5)
    out = det.poll(0.61)
    assert {(x.worker, x.state) for x in out} == {(0, DEAD), (1, SUSPECT)}
    assert all(x.epoch == 5 for x in out)
    r = det.heartbeat(0, 1.0)
    assert r.state == RECOVERED and r.epoch == 5


# ---------------------------------------------------------------------------
# The detector against the JAX package's on the same traces
# ---------------------------------------------------------------------------

def _trace(det, rng, workers: int, rounds: int):
    """Drive ``det`` with a seeded trace of beats, silences, epoch bumps
    and deadline polls on the virtual clock ``run_under_faults`` uses;
    returns every verdict and state as plain tuples."""
    out = []
    silent = set()
    for t in range(rounds):
        now = t * 0.1
        for w in range(workers):
            if rng.random() < 0.15:
                silent ^= {w}
            if w not in silent:
                v = det.heartbeat(w, now)
                if v is not None:
                    out.append(("beat", dataclasses.astuple(v)))
        if rng.random() < 0.1:
            det.set_epoch(det.epoch + 1)
        out += [("poll", dataclasses.astuple(v))
                for v in det.poll(now + 0.05)]
        out.append(("states", tuple(det.state(w) for w in range(workers)),
                    tuple(det.suspect_timeout(w) for w in range(workers))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_detector_matches_the_jax_package_on_seeded_traces(seed):
    cfg_kw = dict(suspect_timeout_s=0.25, confirm_timeout_s=0.3,
                  backoff=2.0, max_backoff=8.0)
    got = _trace(FailureDetector(range(6), DetectorConfig(**cfg_kw)),
                 np.random.default_rng(seed), 6, 60)
    want = _trace(jax_health.FailureDetector(
        range(6), jax_health.DetectorConfig(**cfg_kw)),
        np.random.default_rng(seed), 6, 60)
    assert got == want
    assert any(e[0] == "poll" for e in got) and \
        any(e[0] == "beat" for e in got)


# ---------------------------------------------------------------------------
# apply_verdict: detection -> membership
# ---------------------------------------------------------------------------

def test_suspect_verdict_shrinks_like_a_scripted_leave():
    mc = MembershipController(range(8))
    ev = mc.apply_verdict(Verdict(3, SUSPECT, epoch=0, at=0.45,
                                  silent_s=0.35))
    assert ev.kind == "shrink" and mc.epoch == 1
    assert mc.membership.world_size == 4
    assert 3 not in mc.membership.active


def test_recovered_verdict_defers_to_the_barrier():
    mc = MembershipController(range(4))
    mc.apply_verdict(Verdict(1, SUSPECT, 0, 0.45, 0.35))
    ev = mc.apply_verdict(Verdict(1, RECOVERED, mc.epoch, 0.8, 0.5))
    assert ev.kind == "defer"
    assert mc.membership.pending == (1,)
    assert mc.at_sync_barrier().kind == "regrow"
    assert mc.membership.world_size == 4


def test_dead_verdict_for_already_removed_worker_is_a_noop():
    mc = MembershipController(range(4))
    mc.apply_verdict(Verdict(1, SUSPECT, 0, 0.45, 0.35))
    ev = mc.apply_verdict(Verdict(1, DEAD, mc.epoch, 0.8, 0.7))
    assert ev.kind == "noop" and mc.membership.world_size == 2


def test_unactionable_verdict_state_raises():
    mc = MembershipController(range(4))
    with pytest.raises(ValueError):
        mc.apply_verdict(Verdict(1, ALIVE, 0, 0.1, 0.0))


def test_stale_epoch_verdict_rejected_after_topology_eviction():
    """A detector verdict raised against an evicted dead-epoch topology is
    rejected, not applied to the world the cluster has since rebuilt."""
    plan_mod.clear_plan_cache()
    tree = {"w": tr.Spec((256,), torch.float32)}
    cfg = AveragingConfig(group_size=2, bucket_bytes=4096)
    old_topo = Topology.flat(("data",), (8,))
    compile_plan(old_topo, tree, cfg)

    mc = MembershipController(range(8))
    stale = Verdict(1, SUSPECT, epoch=0, at=0.45, silent_s=0.35)
    assert mc.apply_verdict(Verdict(3, SUSPECT, 0, 0.45, 0.35)).kind == \
        "shrink"
    assert plan_mod.evict_topology(old_topo) >= 1

    before = mc.membership
    ev = mc.apply_verdict(stale)
    assert ev.kind == "rejected-stale-epoch"
    assert mc.membership == before
    assert 1 in mc.membership.active
    assert mc.apply_verdict(
        dataclasses.replace(stale, epoch=mc.epoch)).kind == "shrink"


# ---------------------------------------------------------------------------
# SkipLedger: host-side staleness accounting
# ---------------------------------------------------------------------------

def test_skip_ledger_charges_and_aborts_past_the_bound():
    led = SkipLedger(tau=3)
    assert [led.charge(1, t) for t in range(3)] == [1, 2, 3]
    assert led.max_age() == 3 == max_staleness_bound(3)
    with pytest.raises(StalenessBoundExceeded):
        led.charge(1, 3)


def test_skip_ledger_reset_on_rejoin_and_drop_on_death():
    led = SkipLedger(tau=2)
    led.charge(1, 0)
    led.charge(2, 0)
    led.charge(1, 1)
    led.reset(1)
    assert led.ages == {2: 1}
    led.charge(1, 2)
    assert led.ages[1] == 1
    led.drop(2)
    assert 2 not in led.ages
    snap = led.snapshot()
    assert snap["total_skipped"] == {1: 3, 2: 1}
    assert snap["peak_age"] == 2
    led.charge(2, 3)
    assert led.ages[2] == 1


def test_skip_ledger_empty_max_age():
    assert SkipLedger(tau=4).max_age() == 0
