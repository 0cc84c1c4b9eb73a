"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports JAX or anything of the JAX package ``repro``."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
JAX_PACKAGE_NAME = re.compile(r"\brepro(?!_torch)\b\.|\bimport\s+repro\b(?!_)"
                              r"|\bjax\b")

IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m == "repro" or m.startswith(("repro.", "jax"))))
assert not leaked, leaked
print("MODULES", " ".join(names))
print("IMPORTED", len(names))
"""
# slice 6: elastic membership, the failure detector and seeded faults
SLICE_6_MODULES = ("repro_torch.core.elastic", "repro_torch.core.health",
                   "repro_torch.core.faults", "repro_torch.launch.elastic")


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n = int(out.stdout.split("IMPORTED")[1])
    assert n == len(list(PKG.rglob("*.py")))
    modules = out.stdout.split("MODULES")[1].split("IMPORTED")[0].split()
    assert set(SLICE_6_MODULES) <= set(modules)


@pytest.mark.parametrize("module", ["repro_torch.serve.kv_transfer",
                                    "repro_torch.serve.handoff"])
def test_slice_8_modules_import_without_jax(module):
    """The disaggregated-serving and handoff modules import with ``jax``
    blocked and load nothing of it or of ``repro``."""
    code = (f"import sys; sys.modules['jax'] = None; import {module}; "
            "leaked = sorted(m for m, mod in sys.modules.items() if mod "
            "is not None and (m == 'repro' or m.startswith(('repro.', "
            "'jax')))); assert not leaked, leaked")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_port_sources_never_name_jax_or_repro():
    for path in PORT_FILES:
        for i, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#")[0]
            if code.lstrip().startswith(("import ", "from ")):
                assert not JAX_PACKAGE_NAME.search(code), \
                    f"{path.relative_to(ROOT)}:{i}: {line.strip()}"


def test_chip_smoke_needs_cuda():
    """Without a card the script exits non-zero and prints no result."""
    if _has_cuda():
        return
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _has_cuda() -> bool:
    import torch
    return torch.cuda.is_available()


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


NO_LAUNCHES = {"flash_attention": 0, "group_average_combine": 0,
               "group_average_combine_multi": 0, "rglru_scan": 0,
               "rglru_scan_tma": 0, "rglru_scan_walk": 0}


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


def test_chip_smoke_ranks_phase_at_smoke_size_on_cpu(tmp_path):
    """chip_smoke's ranks phase rehearsed on the CPU at smoke size: four
    gloo ranks under torchrun, 6 steps (both offsets and a sync); checks
    (b)-(e) hold (the wire average equals the stacked plan's on both
    offsets, the checkpoint reloads to the gathered state, the stacked
    twin ends bit-identical after moving the params), and no kernel
    launches off the card, so check (a) refuses the CPU run."""
    import pytest

    smoke = _chip_smoke()
    spec = smoke.ranks_spec(device="cpu", smoke=True, n_layers=None,
                            seq_len=16, global_batch=8, steps=6)
    stats = smoke.ranks_phase(spec, tmp_path / "ranks", timeout=240)
    assert stats["stacked_equals_wire"] == {"0": True, "1": True}
    assert [e["sync"] for e in stats["ranks"][0]["log"]] == \
        [False] * 4 + [True, False]
    assert [r["rank"] for r in stats["ranks"]] == [0, 1, 2, 3]
    e = stats["check_e"]
    assert e["max_loss_rel_diff"] <= smoke.RANKS_LOSS_RTOL
    assert e["params_bit_identical"] and e["differing_elements"] == 0
    assert e["elements"] > 0 and e["max_param_change"] > 0
    s = stats["summary"]
    assert s["wire_bytes_a_group_step"] > 0
    assert s["device_idle_share"] is None        # no card, no device time
    assert not (tmp_path / "ranks" / "ckpt").exists()
    with pytest.raises(AssertionError, match="K1, K2, K3, K4"):
        smoke.check_ranks_launches(stats)


def test_chip_smoke_ranks_check_e_fails_on_a_skipped_average(tmp_path,
                                                             monkeypatch):
    """Check (e) can fail: a stacked twin in which one replica skips one
    group average (row 1 at step 2) parts from the correct ranks, and the
    phase fails on (e)."""
    import pytest

    smoke = _chip_smoke()
    make = smoke.ranks_trainer

    def faulty_twin(spec, world=None):
        trainer = make(spec, world)
        comm, calls = trainer.averager.comm, []

        def skip_row_1(tree, phase):
            calls.append(phase)
            own = [a[1].clone() for a in tr.tree_leaves(tree)]
            out = comm(tree, phase)
            if len(calls) == 3:             # step 2: row 1 keeps its own
                for a, b in zip(tr.tree_leaves(out), own):
                    a[1].copy_(b)
            return out
        trainer.averager.comm = skip_row_1
        return trainer

    from repro_torch.core import tree as tr
    monkeypatch.setattr(smoke, "ranks_trainer", faulty_twin)
    spec = smoke.ranks_spec(device="cpu", smoke=True, n_layers=None,
                            seq_len=16, global_batch=8, steps=6)
    with pytest.raises(AssertionError, match="check \\(e\\)"):
        smoke.ranks_phase(spec, tmp_path / "ranks", timeout=240)


def test_chip_smoke_ranks_phase_fails_when_a_rank_fails(tmp_path):
    """Ranks asked for a card on a machine without one raise (none carries
    on on the CPU), and torchrun's failure fails the phase."""
    import pytest

    smoke = _chip_smoke()
    spec = smoke.ranks_spec(device="cuda", smoke=True, n_layers=None,
                            seq_len=16, global_batch=8, steps=1)
    if _has_cuda():
        return
    with pytest.raises(AssertionError, match="no CUDA device"):
        smoke.ranks_phase(spec, tmp_path / "ranks", timeout=240)


def test_chip_smoke_model_phase_at_smoke_size_on_cpu(tmp_path):
    """chip_smoke's model phase rehearsed on the CPU at smoke size: eight
    gloo ranks under torchrun as data 4 x model 2 (model minor), 6 steps
    (both offsets and a sync); checks (b)-(f) hold: the wire average of
    each model coordinate's slices equals the stacked plan's on both
    offsets, the leaves held whole agree over every model group at every
    step and not after the step without f in one layer, the stacked twin's
    losses within the bound, the served tokens and logits the one-rank
    run's; no kernel launches off the card, so check (a) refuses the CPU
    run."""
    import pytest

    smoke = _chip_smoke()
    spec = smoke.model_spec(device="cpu", smoke=True, n_layers=None,
                            seq_len=16, global_batch=8, steps=6, prompt=16,
                            new=4)
    stats = smoke.model_phase(spec, tmp_path / "model", timeout=240)
    assert stats["stacked_equals_wire"] == {"0": [True, True],
                                            "1": [True, True]}
    assert stats["check_c"] == [True] * 6 and stats["fault_check_c"] is False
    assert [e["sync"] for e in stats["ranks"][0]["log"]] == \
        [False] * 4 + [True, False]
    assert [(r["rank"], r["dp"], r["model"]) for r in stats["ranks"]] == \
        [(r, r // 2, r % 2) for r in range(8)]
    assert stats["check_d"]["max_loss_rel_diff"] <= smoke.MODEL_LOSS_RTOL
    e = stats["serve_check"]
    assert e["ok"] and e["tokens_compared"] > 0
    s = stats["summary"]
    assert s["tp_bytes_a_step"] > 0 and s["wire_bytes_a_group_step"] > 0
    assert s["device_idle_share"] is None        # no card, no device time
    smoke.check_model_held(stats, None)
    with pytest.raises(AssertionError, match="K1, K2, K3, K4"):
        smoke.check_model_launches(stats)


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
    assert runs["chaos"]["state_digest"] == runs["replay"]["state_digest"]
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


def _fsdp_phase(smoke, keep=None):
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return smoke.fsdp_phase(smoke.fsdp_config(smoke=True), device="cpu",
                                seq_len=16, global_batch=16, keep=keep)
    finally:
        torch.set_num_threads(threads)


_FSDP_RUN = {}


def _fsdp_run():
    """One rehearsal of the FSDP phase (its stats and what it keeps for
    the streamed phase), shared by the FSDP and streamed rehearsals."""
    if not _FSDP_RUN:
        smoke = _chip_smoke()
        kept = {}
        _FSDP_RUN.update(smoke=smoke, stats=_fsdp_phase(smoke, kept),
                         kept=kept)
    return _FSDP_RUN["smoke"], _FSDP_RUN["stats"], _FSDP_RUN["kept"]


def test_chip_smoke_fsdp_phase_at_smoke_size_on_cpu():
    """chip_smoke's FSDP phase rehearsed on the CPU at smoke size (4 pods
    of 2, 5 steps: the group steps at t = 0..3, the sync at t = 4): checks
    (b)-(e) and (g) hold, the planted one-ulp nudge fails (b), the run's
    combines are the ones ``fsdp_combines`` gives the K1/K2 phase, and no
    kernel launches off the card, so checks (a) and (f) refuse the CPU
    run.  It keeps pod 0's final canonical params and momentum and the
    consolidated weights for the streamed phase."""
    import pytest

    smoke, stats, kept = _fsdp_run()
    assert stats["checked"] == {0: True, 1: True, "pod_mean_grads": True}
    assert stats["planted_fails"] is True
    assert (stats["pods"], stats["pod_size"], stats["replicas"]) == (4, 2, 8)
    assert [e["sync"] for e in stats["steps"]] == [False] * 4 + [True]
    assert set(kept) == {"params", "momentum", "weights"}
    assert stats["grads_pass"] is None
    assert stats["conversions"]["round_trip"] and \
        stats["conversions"]["consolidated_equals_pods"]
    assert stats["launches"] == NO_LAUNCHES
    assert {k: v["n_prefills"] for k, v in stats["serving"].items()} == \
        {"consolidated": smoke.FSDP_REQUESTS, "pod 0": smoke.FSDP_REQUESTS}
    held = {"combines": smoke.fsdp_combines(smoke.fsdp_config(smoke=True))}
    smoke.check_fsdp_held(stats, held)
    with pytest.raises(AssertionError, match="check \\(a\\)"):
        smoke.check_fsdp_held(stats, {"combines": smoke.fsdp_combines(
            smoke.fsdp_config())})
    with pytest.raises(AssertionError, match="check \\(a\\)"):
        smoke.check_fsdp_launches(stats)
    with pytest.raises(AssertionError, match="check \\(f\\)"):
        smoke.check_fsdp_memory(stats)
    r = stats["reckoning"]
    assert r["peak"] == max(r["train_peak"], r["average_peak"])
    assert r["replicated_peak"] > r["average_peak"]


def test_chip_smoke_streamed_phase_at_smoke_size_on_cpu():
    """chip_smoke's streamed phase rehearsed on the CPU at smoke size after
    the FSDP rehearsal: checks (b)-(d) and (f) hold (the streamed grads
    equal the gather-all ones bit for bit, the planted one-ulp nudge fails
    (b), losses, final params and momentum and serving weights equal the
    FSDP run's), every pod's fwd+bwd reads ``expected_stream_gathers``
    buckets, the combines are those ``streamed_combines`` gives the K1/K2
    phase, and no kernel launches off the card, so checks (a) and (e)
    refuse the CPU run."""
    import pytest
    import torch

    smoke, fsdp, kept = _fsdp_run()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        stats = smoke.streamed_phase(smoke.fsdp_config(smoke=True), fsdp,
                                     kept, device="cpu", seq_len=16,
                                     global_batch=16)
    finally:
        torch.set_num_threads(threads)
    assert all(stats["checked"].values()) and len(stats["checked"]) == 7
    assert stats["checked"]["planted_fails"] is True
    assert stats["losses"] == fsdp["losses"]
    assert stats["n_spans"] == smoke.fsdp_config(smoke=True).n_layers
    assert stats["n_buckets"] == stats["n_spans"] + 2
    assert [e["gathers_per_pod"] for e in stats["steps"]] == \
        [stats["expected_stream_gathers"]] * smoke.FSDP_STEPS
    assert stats["conversions"]["via_replicated"] and \
        stats["conversions"]["via_gather_all"]
    assert stats["launches"] == NO_LAUNCHES
    g = stats["gathered_bytes"]
    assert g["stream_peak"] < g["full"]
    r, f = stats["grads_pass_reckoning"], stats["fsdp_grads_pass_reckoning"]
    assert r["accumulator"] == f["accumulator"] and r["grads"] < f["grads"]
    cfg = smoke.fsdp_config(smoke=True)
    smoke.check_streamed_held(stats, {"combines": smoke.streamed_combines(
        cfg)})
    with pytest.raises(AssertionError, match="check \\(a\\)"):
        smoke.check_streamed_held(stats, {"combines": smoke.fsdp_combines(
            cfg)})
    with pytest.raises(AssertionError, match="check \\(a\\)"):
        smoke.check_streamed_launches(stats)
    with pytest.raises(AssertionError, match="check \\(e\\)"):
        smoke.check_streamed_memory(stats)


def test_chip_smoke_fsdp_check_b_fails_on_a_planted_ulp(monkeypatch):
    """Check (b) can fail: the sharded average of buffers one of whose
    pod rows is nudged by one ulp differs from the replicated twin of the
    unnudged rows, directly and when the phase's own average runs on the
    nudged buffers."""
    import pytest
    import torch

    from repro_torch.core import plan as plan_mod

    smoke = _chip_smoke()
    cfg = smoke.fsdp_config(smoke=True).variant(dtype="bfloat16")
    plan = smoke.fsdp_plan(cfg)
    rep = plan_mod.compile_plan(plan.eff_topology, plan.storage_struct,
                                plan_mod.AveragingConfig(group_size=2))
    gen = torch.Generator().manual_seed(0)
    pre = tuple(torch.randn(plan.P_eff, n, generator=gen).to(d)
                for n, d in zip(plan.shard_layout.bucket_sizes,
                                plan.shard_layout.bucket_dtypes))
    for off in plan.offsets:
        out = plan.average_offset(pre, off)
        assert smoke.sharded_average_matches(plan, rep, pre, out, off)
        nudged = smoke.planted_ulp(plan, pre, off)
        assert sum(int((a != b).sum()) for a, b in zip(nudged, pre)) == 1
        assert not smoke.sharded_average_matches(plan, rep, nudged, out, off)
    average = plan_mod.AveragingPlan._average_sharded
    monkeypatch.setattr(
        plan_mod.AveragingPlan, "_average_sharded",
        lambda self, shards, offset: average(
            self, smoke.planted_ulp(self, shards, offset), offset))
    with pytest.raises(AssertionError, match="check \\(b\\)"):
        _fsdp_phase(smoke)
