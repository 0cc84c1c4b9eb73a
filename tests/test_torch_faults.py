"""The port's seeded fault injection (``repro_torch/core/faults.py``) and
its chaos runs: the host-side cases of tests/test_faults.py against the
port, schedules held to the JAX package's (fingerprint, straggler trace),
the wall-clock ``FaultInjector`` inside the port's ``Trainer.step_once``
(tests/test_nonfinite_guard.py's case), and the chaos matrix of
tests/test_faults.py on the port's ``ElasticTrainer`` over replica rows
on the CPU (detector-driven: no test body calls ``leave``)."""

import numpy as np
import pytest
import torch

from repro.core import faults as jax_faults
from repro_torch.configs import get_config
from repro_torch.core import faults
from repro_torch.core import tree as tr
from repro_torch.core.faults import (FaultEvent, FaultInjector, FaultSchedule,
                                     InjectedCrash, InjectedHang, crash,
                                     delay, hang)
from repro_torch.core.health import DetectorConfig
from repro_torch.core.replica import ReplicaState
from repro_torch.launch.elastic import ElasticTrainer
from repro_torch.launch.train import Trainer

ARCH = "qwen3-0.6b"
SEQ = 16        # the chaos runs' sequence length: the schedule, not the
                # model, decides every membership change


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: under the suite's parallel workers more intra-op
    threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# FaultEvent validation + constructors
# ---------------------------------------------------------------------------

def test_event_validation():
    with pytest.raises(ValueError):
        FaultEvent(0, 0, "melt")
    with pytest.raises(ValueError):
        FaultEvent(0, 0, faults.DELAY, ms=0.0)
    with pytest.raises(ValueError):
        FaultEvent(5, 0, faults.HANG, until=5)


def test_fault_constructors():
    d = delay(3, 7, 320.0)
    assert (d.step, d.worker, d.kind, d.ms) == (7, 3, faults.DELAY, 320.0)
    h = hang(1, 2, recover_after=3)
    assert (h.kind, h.until) == (faults.HANG, 5)
    assert hang(1, 2).until is None
    c = crash(0, 4, rejoin_after=2)
    assert (c.kind, c.until) == (faults.CRASH, 6)


# ---------------------------------------------------------------------------
# FaultSchedule: ordering, lookup, fingerprint determinism
# ---------------------------------------------------------------------------

def test_schedule_sorted_and_lookup():
    s = FaultSchedule.of(crash(0, 9), delay(2, 1, 10.0), hang(1, 1))
    assert [e.step for e in s] == [1, 1, 9]
    assert len(s) == 3 and s.max_step == 9
    assert {e.kind for e in s.at(1)} == {faults.DELAY, faults.HANG}
    assert s.at(5) == ()
    assert s.delays_at(1) == {2: 10.0 / 1e3}
    assert FaultSchedule().max_step == -1


def test_fingerprint_is_order_independent_and_content_sensitive():
    a = FaultSchedule.of(delay(2, 1, 10.0), hang(1, 3))
    b = FaultSchedule.of(hang(1, 3), delay(2, 1, 10.0))
    assert a.fingerprint() == b.fingerprint()
    c = FaultSchedule.of(hang(1, 3), delay(2, 1, 11.0))
    assert a.fingerprint() != c.fingerprint()
    assert a.fingerprint() in repr(a)


def test_straggler_trace_is_seed_deterministic():
    a = FaultSchedule.straggler_trace(16, 50, seed=7)
    b = FaultSchedule.straggler_trace(16, 50, seed=7)
    assert a.events == b.events
    assert a.fingerprint() == b.fingerprint()
    assert a.fingerprint() != FaultSchedule.straggler_trace(
        16, 50, seed=8).fingerprint()
    for t in range(50):
        evs = a.at(t)
        assert len(evs) == 2 and len({e.worker for e in evs}) == 2
        assert all(e.kind == faults.DELAY and e.ms == 320.0 for e in evs)


def test_straggler_trace_clamps_to_world():
    s = FaultSchedule.straggler_trace(2, 4, n_stragglers=5)
    assert all(len(s.at(t)) == 2 for t in range(4))


# ---------------------------------------------------------------------------
# Schedules are shared with the JAX package
# ---------------------------------------------------------------------------

def _both(build):
    """The same schedule built by each package's module."""
    return build(faults), build(jax_faults)


@pytest.mark.parametrize("build", [
    lambda m: m.FaultSchedule.of(m.hang(1, 2, recover_after=3),
                                 m.crash(3, 8, rejoin_after=3)),
    lambda m: m.FaultSchedule.of(m.delay(1, 2, 320.0), m.hang(3, 2),
                                 m.crash(0, 9), m.delay(2, 2, 0.5)),
    lambda m: m.FaultSchedule(),
], ids=["chaos_demo", "mixed", "empty"])
def test_fingerprint_equals_the_jax_packages(build):
    mine, theirs = _both(build)
    assert mine.fingerprint() == theirs.fingerprint()
    assert [tuple(vars(e).values()) for e in mine] == \
        [tuple(vars(e).values()) for e in theirs]


@pytest.mark.parametrize("P,steps,n,seed", [(16, 50, 2, 7), (8, 12, 3, 0),
                                            (2, 4, 5, 1)])
def test_straggler_trace_equals_the_jax_packages(P, steps, n, seed):
    mine, theirs = _both(lambda m: m.FaultSchedule.straggler_trace(
        P, steps, n_stragglers=n, seed=seed))
    assert mine.fingerprint() == theirs.fingerprint()
    for t in range(steps):
        assert mine.delays_at(t) == theirs.delays_at(t)


# ---------------------------------------------------------------------------
# FaultInjector: wall-clock effects for one worker identity
# ---------------------------------------------------------------------------

def test_injector_delay_sleeps_scaled_and_ignores_other_workers():
    slept = []
    s = FaultSchedule.of(delay(0, 2, 100.0), delay(1, 2, 999.0))
    inj = FaultInjector(s, worker=0, time_scale=0.5, sleep=slept.append)
    inj.before_step(0)
    inj.before_step(2)
    assert slept == [pytest.approx(0.05)]
    assert inj.delayed_ms == 100.0


def test_injector_crash_raises():
    inj = FaultInjector(FaultSchedule.of(crash(0, 3)), worker=0,
                        sleep=lambda _: None)
    inj.before_step(2)
    with pytest.raises(InjectedCrash):
        inj.before_step(3)


def test_injector_hang_sleeps_grace_then_raises():
    slept = []
    inj = FaultInjector(FaultSchedule.of(hang(0, 1)), worker=0,
                        hang_grace_s=0.02, sleep=slept.append)
    with pytest.raises(InjectedHang):
        inj.before_step(1)
    assert slept == [pytest.approx(0.02)]


def test_poisoned_replica_skips_alone_and_injector_crashes_trainer():
    """tests/test_nonfinite_guard.py's Trainer case on the port: a NaN row
    freezes alone under the non-finite guard while the other trains, and
    the wall-clock injector fires inside ``step_once``."""
    cfg = get_config(ARCH, smoke=True)
    kw = dict(device="cpu", averager="local_sgd", tau=10_000,
              learning_rate=0.1, seed=0, seq_len=SEQ)
    host = Trainer(cfg, 2, **kw).state

    def poison(a):
        a = a.clone()
        a[1] = float("nan")
        return a

    bad_params = tr.tree_map(poison, host.params)
    trainer = Trainer(cfg, 2, init_state=ReplicaState(
        bad_params, host.opt_state, host.step, host.phase), **kw)
    for t in range(3):
        trainer.step_once(t)
    assert trainer.last_metrics["skipped_nonfinite"] == 0.5
    assert trainer.skipped_nonfinite == 3.0
    after = trainer.state
    for leaf in tr.tree_leaves(after.params):
        a = leaf.float()
        assert torch.isnan(a[1]).all(), "poisoned row must stay frozen"
        assert torch.isfinite(a[0]).all(), "healthy row must keep training"
    for leaf, init in zip(tr.tree_leaves(after.opt_state.momentum),
                          tr.tree_leaves(host.opt_state.momentum)):
        assert torch.equal(leaf[1], init[1])
    assert after.opt_state.count.tolist() == [3, 0]
    assert after.step == 3

    trainer.fault_injector = FaultInjector(FaultSchedule.of(crash(0, 4)),
                                           worker=0)
    trainer.step_once(3)
    with pytest.raises(InjectedCrash):
        trainer.step_once(4)
    assert trainer.state.step == 4


# ---------------------------------------------------------------------------
# The chaos matrix on the port (detector-driven: no scripted leaves)
# ---------------------------------------------------------------------------

# Off-grid timeouts, as the JAX package's chaos tests use: the virtual
# clock lands on multiples of 0.05 s and the default 0.25/0.30 thresholds
# sit on that grid; 0.28/0.33 keep >= 0.02 s of margin to every point.
DET = DetectorConfig(suspect_timeout_s=0.28, confirm_timeout_s=0.33)


def make_et(world=4, tau=4, seed=0):
    return ElasticTrainer(get_config(ARCH, smoke=True), world, device="cpu",
                          tau=tau, group_size=2, seed=seed,
                          learning_rate=0.05, seq_len=SEQ)


def kinds(rep):
    return [e["kind"] for e in rep["events"]]


def test_chaos_hang_mid_round_double_fault_confirms_dead():
    """Two workers hang for good in the same round: the first suspect
    shrinks 4 -> 2, the batch-mate verdict drains the demoted spare, both
    confirm dead, the ledger stops aging them and the world stays 2."""
    et = make_et()
    sched = FaultSchedule.of(faults.hang(1, 2), faults.hang(3, 2))
    rep = et.run_under_faults(10, sched, detector=DET)
    ks = kinds(rep)
    assert ks.count("hang") == 2 and ks.count("suspect") == 2, ks
    assert ks.count("shrink") == 1, ks
    assert ks.count("confirm-dead") == 2, ks
    for absent in ("recover", "wake", "regrow", "stale-verdict-rejected"):
        assert absent not in ks, ks
    assert [r["world"] for r in rep["records"]] == [4] * 4 + [2] * 6
    assert [e["kind"] for e in et.epoch_log] == ["shrink"]
    m = et.controller.membership
    assert m.world_size == 2 and not m.spares and not m.pending, m
    st = rep["staleness"]
    assert st["total_skipped"] == {1: 4} and st["ages"] == {}, st
    assert st["peak_age"] == 4 == et.tau, st
    assert np.isfinite([r["loss"] for r in rep["records"]]).all()


def test_chaos_crash_before_sync_rejoins_and_replays_bit_identical():
    """A worker crashes right before a tau-sync, is detected, rejoins at
    the next barrier; replaying the same schedule on a fresh trainer
    reproduces the state bit for bit (digest, events, losses)."""
    sched = FaultSchedule.of(faults.crash(1, 6, rejoin_after=3))

    def one_run():
        et = make_et()
        return et, et.run_under_faults(13, sched, detector=DET)

    et, rep = one_run()
    ks = kinds(rep)
    for needed in ("crash", "suspect", "shrink", "wake", "recover",
                   "regrow"):
        assert needed in ks, ks
    assert [r["world"] for r in rep["records"]] == [4] * 8 + [2] * 4 + [4]
    assert [e["kind"] for e in et.epoch_log] == ["shrink", "regrow"]
    st = rep["staleness"]
    assert st["total_skipped"] == {1: 4} and st["ages"] == {}, st
    m = et.controller.membership
    assert m.world_size == 4 and not m.spares and not m.pending, m

    _, rep2 = one_run()
    assert rep2["schedule_fingerprint"] == rep["schedule_fingerprint"]
    assert rep2["state_digest"] == rep["state_digest"]
    assert rep2["events"] == rep["events"]
    assert rep2["staleness"] == rep["staleness"]
    assert [r["loss"] for r in rep2["records"]] == \
        [r["loss"] for r in rep["records"]]


def test_chaos_flapping_worker_backoff_absorbs_second_delay():
    """A 320 ms straggler trips one shrink/rejoin cycle; the flap doubles
    its suspect timeout, so the identical second delay is absorbed and
    the membership never churns again."""
    et = make_et()
    sched = FaultSchedule.of(faults.delay(1, 2, 320.0),
                             faults.delay(1, 9, 320.0))
    rep = et.run_under_faults(14, sched)
    ks = kinds(rep)
    assert ks.count("delay") == 2, ks
    assert ks.count("suspect") == 1, ks
    assert ks.count("shrink") == 1 and ks.count("regrow") == 2, ks
    assert ks.count("recover") == 1 and "confirm-dead" not in ks, ks
    assert [r["world"] for r in rep["records"]] == [4] * 4 + [2] * 4 + [4] * 6
    assert [e["kind"] for e in et.epoch_log] == ["shrink", "regrow"]
    st = rep["staleness"]
    assert st["total_skipped"] == {1: 4} and st["ages"] == {}, st
    m = et.controller.membership
    assert m.world_size == 4 and not m.spares and not m.pending, m
    assert np.isfinite([r["loss"] for r in rep["records"]]).all()
