#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (``nvidia-smi``).
2. Builds every kernel of ``src/repro_torch/kernels/csrc`` with ``nvcc`` for
   sm_90a into the git-ignored ``build/kernels/``.
3. Kernel phase: the flash-attention kernel K3 against its plain torch
   version on the card (f32 to 2e-4, bf16 to 3e-2) over the kernel test
   shapes and the serving slice's prefill shapes; times the kernel, the
   plain version and ``F.scaled_dot_product_attention`` (the library
   yardstick, used nowhere in the port) against the roofline bound.
4. Slice phase: ``ServeScheduler`` serves tinyllama-1.1b at full width in
   bf16 (random weights from a seeded torch generator) over 8 ragged
   requests with a pool small enough to force a recompute preemption; checks
   that every prefill attention went through K3, that every request
   finishes with in-vocab tokens, and, for 2 requests, that the first token
   and the first paged decode step's logits match the dense uncontended
   serving path.
5. Prints a ``kernels`` JSON line, then ``{"ok": true, "device": ...}`` last.

Exits non-zero, printing no result, without CUDA or without the repo's
``src/`` beside it.  TF32 is off for matmuls and cuDNN so float32 means
float32.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core
# rate, float32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

# tests/test_kernels.py ATTN_CASES: (b, sq, sk, h, kh, hd, causal, window, dtype)
ATTN_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, "float32"),
    (1, 256, 256, 4, 4, 32, True, 64, "float32"),
    (2, 100, 100, 2, 1, 64, False, None, "float32"),
    (1, 128, 256, 4, 2, 128, True, None, "float32"),
    (1, 64, 64, 2, 2, 64, True, None, "bfloat16"),
    (1, 72, 72, 3, 1, 48, True, 16, "float32"),
]
# each shape in both dtypes: the kernel has a float32 and a bfloat16 path
KERNEL_CASES = list(dict.fromkeys(c[:8] + (dt,) for c in ATTN_CASES
                                  for dt in ("float32", "bfloat16")))
# tinyllama-1.1b prefill at B=1: H=32, KH=4, hd=64, bf16, causal
SLICE_LENGTHS = (1, 100, 1024, 2048)
SLICE_SHAPE_FOR_LINE = 1024          # the kernels line reports this shape
TOL = {"float32": 2e-4, "bfloat16": 3e-2}

# slice phase
ARCH = "tinyllama-1.1b"
N_REQUESTS, PROMPT_MIN, PROMPT_MAX, MAX_NEW = 8, 64, 1024, 32
BLOCK_SIZE, MAX_BLOCKS_PER_REQ, MAX_BATCH = 16, 96, 8
SPARE_BLOCKS = 2                     # pool = prompts + SPARE: growth preempts
CHECKED_REQUESTS = (0, 1)
# Paged vs dense first-step logits: the same bf16 model at batch 8 vs 1
# runs other matmul tilings, so the results round differently in bf16 across
# 22 layers.  Held to 5% of the largest reference logit.
LOGIT_RTOL = 0.05


def _sync(device):
    import torch
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def visible_pairs(sq, sk, causal, window) -> int:
    """(query, key) pairs the mask lets through: the work this input needs."""
    q = np.arange(sq)[:, None]
    k = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= k > q - window
    return int(ok.sum())


def attention_bound(b, sq, sk, h, kh, hd, causal, window, dtype):
    """(bound_ms, bound_by): max of bytes over HBM rate and FLOPs over the
    dtype's peak.  Each of q, k, v read once and o written once; 4 FLOPs
    per visible (query, key) pair and head dim (QK^T and PV)."""
    item = 2 if dtype == "bfloat16" else 4
    nbytes = item * (2 * b * sq * h * hd + 2 * b * sk * kh * hd)
    flops = 4.0 * b * h * hd * visible_pairs(sq, sk, causal, window)
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_flops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def kernel_phase(device="cuda"):
    """K3 against its plain version at every listed shape; returns rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    cases = KERNEL_CASES + [(1, L, L, 32, 4, 64, True, None, "bfloat16")
                            for L in SLICE_LENGTHS]
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for b, sq, sk, h, kh, hd, causal, window, dtype in cases:
        dt = getattr(torch, dtype)

        def randn(*shape):
            return torch.randn(shape, generator=gen, device=device).to(dt)

        q, k, v = randn(b, sq, h, hd), randn(b, sk, kh, hd), randn(b, sk, kh, hd)
        out = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        if not math.isfinite(err) or err > TOL[dtype]:
            raise AssertionError(f"K3 disagrees with its plain version at "
                                 f"{(b, sq, sk, h, kh, hd, causal, window, dtype)}:"
                                 f" max abs err {err} > {TOL[dtype]}")
        kernel_ms = time_ms(lambda: fa.flash_attention_cuda(
            q, k, v, causal=causal, window=window))
        plain_ms = time_ms(lambda: fa.flash_attention_plain(
            q, k, v, causal=causal, window=window), iters=5, warmup=1)
        library_ms = None
        if window is None and (not causal or sq == sk):
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=kh != h))
        bound_ms, bound_by = attention_bound(b, sq, sk, h, kh, hd, causal,
                                             window, dtype)
        rows.append({"shape": [b, sq, sk, h, kh, hd], "causal": causal,
                     "window": window, "dtype": dtype, "max_abs_err": err,
                     "tol": TOL[dtype], "ms": kernel_ms, "plain_ms": plain_ms,
                     "library_ms": library_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
    return rows


def make_requests(cfg, seed: int = 0):
    rng = np.random.default_rng(seed)
    lens = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, size=N_REQUESTS)
    return [rng.integers(0, cfg.vocab, (int(n),)).astype(np.int32)
            for n in lens]


def load_model(cfg, device="cuda", seed: int = 0):
    """The port's model with random weights from a seeded torch generator
    on ``device``; returns (model, params, seconds)."""
    import torch
    from repro_torch.models.registry import build_model

    model = build_model(cfg, device=device)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    _sync(device)
    return model, params, time.perf_counter() - t0


def serve_phase(model, params, device="cuda", seed: int = 0):
    """Serve the ragged request set through ``ServeScheduler`` and check it
    against the dense path; returns the run's numbers."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serve import (Request, ServeScheduler, build_prefill,
                                   build_serve_step)

    cfg = model.cfg
    prompts = make_requests(cfg, seed)
    n_blocks = 1 + SPARE_BLOCKS + sum(
        -(-(len(p) + 1) // BLOCK_SIZE) for p in prompts)
    sched = ServeScheduler(model, params, n_blocks=n_blocks,
                           block_size=BLOCK_SIZE,
                           max_blocks_per_req=MAX_BLOCKS_PER_REQ,
                           max_batch=MAX_BATCH)

    prefill_log, decode_log, first_step = [], [], {}
    inner_prefill, inner_decode = sched._do_prefill, sched._decode

    def timed_prefill(req, table):
        _sync(device)
        t = time.perf_counter()
        first = inner_prefill(req, table)
        _sync(device)
        done = time.perf_counter()
        prefill_log.append((req.rid, req.prompt_len, done - t,
                            done - run_start))
        return first

    def timed_decode(params, pool, tables, tokens, positions):
        batch = list(sched.running)         # rows in the order the step built
        _sync(device)
        t = time.perf_counter()
        pool, nxt, logits = inner_decode(params, pool, tables, tokens,
                                         positions)
        _sync(device)
        decode_log.append((int(tables.shape[0]), time.perf_counter() - t))
        for i, req in enumerate(batch):
            if (req.rid in CHECKED_REQUESTS and req.rid not in first_step
                    and int(positions[i]) == req.prompt_len):
                first_step[req.rid] = (int(tokens[i]), logits[i].float().cpu())
        return pool, nxt, logits

    sched._do_prefill, sched._decode = timed_prefill, timed_decode
    for i, p in enumerate(prompts):
        sched.submit(Request(i, p, MAX_NEW))
    ops.reset_launch_counts()
    run_start = time.perf_counter()
    outs = sched.run()
    _sync(device)
    wall_s = time.perf_counter() - run_start
    launches = ops.launch_counts()

    if sorted(outs) != list(range(N_REQUESTS)):
        raise AssertionError(f"unfinished requests: {sorted(outs)}")
    for rid, toks in outs.items():
        if len(toks) != MAX_NEW or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"request {rid}: bad tokens {toks}")
    if sched.blocks.evictions < 1:
        raise AssertionError("the pool never preempted a request")
    if sched.blocks.n_free != n_blocks - 1:
        raise AssertionError("blocks leaked")

    # dense, uncontended reference for the checked requests
    s_view = MAX_BLOCKS_PER_REQ * BLOCK_SIZE
    dense_prefill = build_prefill(model, s_view)
    dense_step = build_serve_step(model)
    checks = []
    for rid in CHECKED_REQUESTS:
        p = prompts[rid]
        tokens = torch.as_tensor(p[None], dtype=torch.int64, device=device)
        logits, caches = dense_prefill(params, {"tokens": tokens})
        cols = torch.arange(logits.shape[-1], device=device)
        first = int(torch.where(cols < cfg.vocab, logits[0, -1],
                                -1e30).argmax())
        if first != outs[rid][0]:
            raise AssertionError(f"request {rid}: paged first token "
                                 f"{outs[rid][0]} != dense {first}")
        tok, paged_logits = first_step[rid]
        if tok != first:
            raise AssertionError(f"request {rid}: first decode fed {tok}")
        _, dense_logits, _ = dense_step(
            params, caches, torch.tensor([[first]], device=device), len(p))
        ref = dense_logits[0, -1, :cfg.vocab].float().cpu()
        got = paged_logits[:cfg.vocab]
        diff = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        if not math.isfinite(diff) or diff > LOGIT_RTOL * scale:
            raise AssertionError(f"request {rid}: paged vs dense logits "
                                 f"differ by {diff} > {LOGIT_RTOL} * {scale}")
        checks.append({"rid": rid, "prompt_len": len(p), "first_token": first,
                       "logits_max_abs_diff": diff, "logits_max_abs": scale})

    prefill_tokens = sum(n for _, n, _, _ in prefill_log)
    prefill_s = sum(t for _, _, t, _ in prefill_log)
    ttft = {}                  # run start (all arrive at 0) to first token
    for rid, _, _, at in prefill_log:
        ttft.setdefault(rid, at)
    by_bucket = {}
    for n_pad, t in decode_log:
        by_bucket.setdefault(n_pad, []).append(t * 1e3)
    return {
        "arch": cfg.name, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
        "d_model": cfg.d_model, "wall_s": wall_s,
        "prompt_lens": [len(p) for p in prompts], "n_blocks": n_blocks,
        "n_prefills": sched.n_prefills, "evictions": sched.blocks.evictions,
        "preempted": sorted(r.rid for r in sched.finished.values()
                            if r.preemptions),
        "n_decode_steps": sched.n_decode_steps,
        "decode_shapes": sorted(sched.decode_shapes_compiled),
        "launches": launches,
        "prefill_tokens": prefill_tokens,
        "prefill_tok_per_s": prefill_tokens / prefill_s,
        "prefill_ms": [(rid, n, t * 1e3) for rid, n, t, _ in prefill_log],
        "ttft_s": [ttft[rid] for rid in range(N_REQUESTS)],
        "decode_ms_per_step": {str(k): float(np.mean(v))
                               for k, v in sorted(by_bucket.items())},
        "decode_steps_per_bucket": {str(k): len(v)
                                    for k, v in sorted(by_bucket.items())},
        "checks": checks,
    }


def profile_phase(model, params, device="cuda", seed: int = 0,
                  decode_steps: int = 4):
    """Kernel time by name and the device's busy share over two windows of
    a fresh scheduler on the same requests: the first step (every prefill
    plus one decode step at batch 8) and the next ``decode_steps`` decode
    steps.  Device numbers are None where the profiler saw no CUDA kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request, ServeScheduler

    prompts = make_requests(model.cfg, seed)
    sched = ServeScheduler(model, params, n_blocks=1 + MAX_BATCH
                           * MAX_BLOCKS_PER_REQ, block_size=BLOCK_SIZE,
                           max_blocks_per_req=MAX_BLOCKS_PER_REQ,
                           max_batch=MAX_BATCH)
    for i, p in enumerate(prompts):
        sched.submit(Request(i, p, MAX_NEW))
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    windows = {}
    for name, n_steps in (("admit_all_prefills_plus_1_decode", 1),
                          (f"{decode_steps}_decode_steps_batch_8",
                           decode_steps)):
        _sync(device)
        with profile(activities=activities) as prof:
            t = time.perf_counter()
            for _ in range(n_steps):
                sched.step()
            _sync(device)
            wall_ms = (time.perf_counter() - t) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        windows[name] = {
            "wall_ms": wall_ms,
            "device_busy_ms": busy_ms if kernels else None,
            "device_idle_share": 1 - busy_ms / wall_ms if kernels else None,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "ms": e.self_device_time_total / 1e3}
                            for e in top],
        }
    return windows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "measures the port on an NVIDIA GPU", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_identity()
    print(f"card: {card}", flush=True)

    t = time.perf_counter()
    reports = _build.build(_build.sources())
    build_s = time.perf_counter() - t
    print(f"build: {_build.sources()} in {build_s:.1f} s", flush=True)
    for name, report in reports.items():
        print(f"--- nvcc {name}.cu ---\n{report}", file=sys.stderr)

    rows = kernel_phase()
    for r in rows:
        print(f"K3 {r['shape']} causal={r['causal']} window={r['window']} "
              f"{r['dtype']}: err {r['max_abs_err']:.3g} (tol {r['tol']}) "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
              f"sdpa {r['library_ms']} ms bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}) [{card}]", flush=True)
    print(json.dumps({"k3_shapes": rows, "card": card}), flush=True)

    cfg = get_config(ARCH)
    model, params, init_s = load_model(cfg)
    print(f"weights: {cfg.name} initialised on the card in {init_s:.2f} s",
          flush=True)
    stats = serve_phase(model, params)
    n_sb = cfg.n_layers
    want = n_sb * stats["n_prefills"]
    got = stats["launches"]["flash_attention"]
    if got != want:
        raise AssertionError(f"K3 launched {got} times on the serving path; "
                             f"expected {n_sb} layers x {stats['n_prefills']}"
                             f" prefills = {want}")
    print(json.dumps({"slice": stats, "card": card}), flush=True)
    print(f"slice [{card}]: {cfg.name} full width bf16, "
          f"{stats['n_prefills']} prefills ({stats['evictions']} evictions), "
          f"prefill {stats['prefill_tok_per_s']:.0f} tok/s, "
          f"TTFT max {max(stats['ttft_s']):.3f} s, decode ms/step by bucket "
          f"{stats['decode_ms_per_step']}", flush=True)

    windows = profile_phase(model, params)
    for name, w in windows.items():
        print(f"profile {name} [{card}]: wall {w['wall_ms']:.2f} ms, device "
              f"busy {w['device_busy_ms']} ms, idle share "
              f"{w['device_idle_share']}", flush=True)
        for k in w["top_kernels"]:
            print(f"    {k['ms']:9.3f} ms {k['calls']:6d}x {k['name']}")
    print(json.dumps({"profile": windows, "card": card}), flush=True)

    main_row = next(r for r in rows if r["shape"] == [
        1, SLICE_SHAPE_FOR_LINE, SLICE_SHAPE_FOR_LINE, 32, 4, 64])
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:26",
        "launches": got,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": main_row["shape"], "dtype": main_row["dtype"],
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
