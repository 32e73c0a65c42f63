#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sharetrade_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases, in order (any failure exits non-zero before the final line):

1. device   — refuse to run without CUDA; print the card's name and power
              limit as ``nvidia-smi`` reports them.
2. build    — compile every CUDA source of the package (one ``nvcc`` per
              source, all started together) and print the build time.
3. kernels  — hold each kernel against its plain PyTorch version (computed
              in float32 from the same inputs) at the shapes the main path
              gives it and the other shapes its TPU counterparts served;
              time kernel, plain version and the library yardstick with CUDA
              events; print one JSON line per shape.
4. serve    — the port's main path: the serving engine on the flagship
              episode transformer at full width (L=2, H=2, Dh=128, window
              201, bf16_mixed, max_batch 64, slots 256), seeded random
              weights and synthetic prices, driven in closed loop through a
              warm phase and an eviction phase. Kernel launch counts are
              reset just before and read just after; the first cold batch's
              logits are held against the same batch through the plain
              attention on the card.
5. cli      — ``python -m sharetrade_tpu_torch.cli serve`` for a few seconds.

Then one ``{"kernels": [...]}`` line, and last the
``{"ok": true, "device": {...}}`` line. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

PHASES = ("build", "kernels", "serve", "cli")
#: Opt-in phases (name them in --phases): a device-time breakdown of one
#: cold and one warm serving tick.
EXTRA_PHASES = ("profile",)

#: Published H100 SXM peaks (NVIDIA data sheet): memory bandwidth and the
#: compute rate for each input type (bf16 on the tensor cores; float32 on
#: the FMA units, which is what the f32 path of the kernel uses).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}

#: Tolerances, kernel against the plain version computed in float32 from
#: the same inputs: |out - ref| <= atol + rtol * |ref|. float32: both sum
#: the same products in f32, in another order. bfloat16: the kernel rounds
#: its output to bf16 (half an ulp, 2^-9 relative) and rounds P to bf16
#: before P.V as the TPU kernel does (absolute noise of a few 1e-3 on
#: outputs of order 1); rtol is one bf16 ulp, 2^-7.
ATOL = {"float32": 2e-5, "bfloat16": 4e-3}
RTOL = {"float32": 0.0, "bfloat16": 2.0 ** -7}
LSE_ATOL = {"float32": 1e-4, "bfloat16": 1e-3}

#: bf16 serving: the first cold batch through the kernel vs through the
#: plain attention, both in the bf16 model. The two attention outputs
#: differ by bf16 roundings; the trunk and heads (policy std 0.01, value
#: He-normal) carry that into logits of order 0.1 and values of order 1.
LOGIT_ATOL = 2e-2
VALUE_ATOL = 5e-2


def _print(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(torch, fn, *, warmup: int = 3, iters: int = 25) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _band_pairs(t: int, window: int | None) -> int:
    """(row, key) pairs a causal band of width ``window`` holds."""
    w = t if window is None else min(window, t)
    return sum(min(r + 1, w) for r in range(t))


def phase_build() -> dict:
    from sharetrade_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    per_source = cuda_build.build_all()
    return {"phase": "build", "seconds": time.perf_counter() - t0,
            "sources": per_source, "nvcc": cuda_build.nvcc_path()}


def check_flash_fwd(torch, *, name: str, batch: int, heads: int, seq: int,
                    head_dim: int, window: int | None, dtype) -> dict:
    import torch.nn.functional as F

    from sharetrade_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(seq * 131 + head_dim)
    shape = (batch, heads, seq, head_dim)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    scale = head_dim ** -0.5
    before = attention.launch_counts["flash_fwd"]
    out, lse = attention.flash_fwd(q, k, v, causal=True, sm_scale=scale,
                                   window=window)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention._plain_forward(
        q.float(), k.float(), v.float(), True, scale, window)
    dname = str(dtype).removeprefix("torch.")
    diff = (out.float() - ref_out).abs()
    err = diff.max().item()
    within = bool((diff <= ATOL[dname] + RTOL[dname] * ref_out.abs()).all())
    lse_err = (lse - ref_lse).abs().max().item()
    ok = (within and lse_err <= LSE_ATOL[dname]
          and bool(torch.isfinite(out).all()))

    kernel_ms = _time_ms(torch, lambda: attention.flash_fwd(
        q, k, v, causal=True, sm_scale=scale, window=window))
    plain_ms = _time_ms(torch, lambda: attention._plain_forward(
        q, k, v, True, scale, window), iters=10)
    if window is None:
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, scale=scale)
    else:
        idx = torch.arange(seq, device="cuda")
        band = (idx[None, :] <= idx[:, None]) & \
            (idx[None, :] > idx[:, None] - window)
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=band, scale=scale)
    library_ms = _time_ms(torch, lib_fn, iters=10)

    elem = q.element_size()
    nbytes = 4 * q.numel() * elem + lse.numel() * 4
    ops = 4 * head_dim * batch * heads * _band_pairs(seq, window)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
    return {
        "phase": "kernels", "kernel": "flash_fwd", "case": name,
        "shape": list(shape), "window": window, "dtype": dname,
        "max_abs_err": err,
        "tolerance": {"atol": ATOL[dname], "rtol": RTOL[dname]},
        "lse_max_abs_err": lse_err, "lse_tolerance": LSE_ATOL[dname],
        "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes, "operations": ops,
        "launches": attention.launch_counts["flash_fwd"] - before,
        "ok": ok,
    }


def phase_kernels(torch) -> list[dict]:
    cases = [
        # The serving shape: a cold batch of 64 sessions, 2 heads, the
        # (L-1)*(W-1) + W = 401-tick prefill, band 201.
        dict(name="serving_bf16", batch=64, heads=2, seq=401, head_dim=128,
             window=201, dtype=torch.bfloat16),
        dict(name="serving_f32", batch=64, heads=2, seq=401, head_dim=128,
             window=201, dtype=torch.float32),
        # The shape class the TPU's streaming kernel (K2) served.
        dict(name="long_banded_bf16", batch=2, heads=2, seq=8192,
             head_dim=128, window=201, dtype=torch.bfloat16),
        dict(name="causal_f32", batch=8, heads=4, seq=256, head_dim=64,
             window=None, dtype=torch.float32),
    ]
    return [check_flash_fwd(torch, **case) for case in cases]


FLAGSHIP = [
    # ppo_tr_episode_b512_u1024_bf16 (benchmarks/run_all.py), served.
    "model.kind=transformer", "model.seq_mode=episode",
    "model.num_layers=2", "model.num_heads=2", "model.head_dim=128",
    "env.window=201", "precision.mode=bf16_mixed",
    "serve.max_batch=64", "serve.slots=256",
]


def kernels_line(results: dict) -> dict:
    """Every kernel of the port, with the Pallas kernels it replaces; the
    numbers are the serving shape's (bf16) and the main path's launches."""
    serving = next(r for r in results["kernels"]
                   if r["case"] == "serving_bf16")
    return {"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "sharetrade_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "sharetrade_tpu/ops/attention.py:88",
        "also_replaces": ["sharetrade_tpu/ops/attention.py:284"],
        "launches": results["serve"]["flash_fwd_launches"],
        "max_abs_err": serving["max_abs_err"],
        "ms": serving["kernel_ms"], "plain_ms": serving["plain_ms"],
        "bound_ms": serving["bound_ms"], "bound_by": serving["bound_by"],
        "library_ms": serving["library_ms"],
        "shape": serving["shape"], "window": serving["window"],
        "dtype": serving["dtype"],
    }]}


def phase_serve(torch, *, device: str = "cuda",
                overrides: list[str] = FLAGSHIP) -> dict:
    """The main path; see the module docstring. ``device``/``overrides``
    exist to rehearse the phase at a small size on the CPU."""
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.env.trading import obs_dim
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.ops import attention
    from sharetrade_tpu_torch.precision import policy_from_config
    from sharetrade_tpu_torch.serve import ServeEngine
    from sharetrade_tpu_torch.serve.driver import make_sessions, run_closed_loop

    cfg = FrameworkConfig().apply_overrides(overrides)
    device = torch.device(device)
    window = cfg.env.window
    prices = PriceDataService(config=cfg.data).request("MSFT").series.prices
    model = build_model(cfg.model, obs_dim(window), device=device)
    params = model.init(torch.Generator().manual_seed(cfg.seed))
    policy = policy_from_config(cfg.precision)
    engine = ServeEngine(model, cfg.serve, params, precision=policy)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    slots = cfg.serve.slots

    # ---- the counted window: counts reset just before, read just after.
    attention.reset_launch_counts()
    before = dict(engine.counters)
    first = make_sessions(prices, window, cfg.serve.max_batch,
                          seed=cfg.seed, prefix="first")
    first_obs = [s.observation() for s in first]
    handles = [engine.submit(s.sid, o) for s, o in zip(first, first_obs)]
    first_results = [h.wait(120.0) for h in handles]
    # Warm phase: the population fits the arena (64 + 192 = 256 slots).
    warm = run_closed_loop(
        engine, make_sessions(prices, window, slots - cfg.serve.max_batch,
                              seed=cfg.seed + 1, prefix="w"),
        concurrency=slots - cfg.serve.max_batch, duration_s=3.0)
    # Eviction phase: 320 sessions > 256 slots, so LRU eviction and cold
    # re-prefill run every tick.
    evict = run_closed_loop(
        engine, make_sessions(prices, window, 320, seed=cfg.seed + 2,
                              prefix="e"),
        concurrency=320, duration_s=3.0)
    drained = engine.drain(60.0)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = attention.launch_counts["flash_fwd"]
    after = dict(engine.counters)
    # ---- end of the counted window.
    stopped = engine.stop(drain=False, timeout_s=10.0)
    delta = {k: after[k] - before[k] for k in after}

    # The first cold batch, again, through the plain attention on the card.
    if any(r is None for r in first_results):
        raise RuntimeError("chip_smoke: a first-batch request failed")
    got_logits = np.stack([r.logits for r in first_results])
    got_values = np.array([r.value for r in first_results])
    sm_scale = cfg.model.head_dim ** -0.5
    plain_model = build_model(
        cfg.model, obs_dim(window), device=device,
        attention_fn=lambda q, k, v, w: attention.reference_attention(
            q, k, v, causal=True, sm_scale=sm_scale, local_window=w))
    with torch.inference_mode():
        ref, _ = plain_model.apply_prefill(
            policy.cast_compute(params),
            torch.from_numpy(np.stack(first_obs)).to(device))
    ref_logits = ref.logits.cpu().numpy()
    ref_values = ref.value.cpu().numpy()
    logit_err = float(np.abs(got_logits - ref_logits).max())
    value_err = float(np.abs(got_values - ref_values).max())

    row = {
        "phase": "serve", "config": overrides, "warmup_s": warmup_s,
        "warm_phase": warm, "evict_phase": evict,
        "counters": delta, "flash_fwd_launches": launches,
        "num_layers": cfg.model.num_layers,
        "first_batch_logit_max_abs_err": logit_err,
        "first_batch_value_max_abs_err": value_err,
        "logit_atol": LOGIT_ATOL, "value_atol": VALUE_ATOL,
        "drained": drained, "stopped_clean": stopped,
    }
    problems = []
    if launches <= 0 or launches != cfg.model.num_layers * delta[
            "cold_batches"]:
        problems.append("flash_fwd launches != num_layers x cold ticks")
    if delta["warm_batches"] <= 0 or delta["evictions"] <= 0:
        problems.append("the warm program or LRU eviction never ran")
    if warm["failed"] or evict["failed"] or delta["failed"]:
        problems.append("requests failed")
    if not (np.isfinite(got_logits).all() and got_logits.shape
            == (cfg.serve.max_batch, cfg.model.num_actions)):
        problems.append("first-batch logits not finite or misshapen")
    if logit_err > LOGIT_ATOL or value_err > VALUE_ATOL:
        problems.append("first-batch outputs disagree with plain attention")
    if not (drained and stopped):
        problems.append("engine did not drain and stop cleanly")
    row["problems"] = problems
    return row


def phase_cli() -> dict:
    """``cli serve`` as a user runs it, on the flagship config."""
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
           "--duration", "3", "--sessions", "320"]
    for item in FLAGSHIP:
        cmd += ["--set", item]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1]) if lines else {}
    ok = (proc.returncode == 0 and len(lines) >= 2
          and summary.get("completed", 0) > 0
          and summary.get("failed", 1) == 0
          and summary.get("flash_fwd_launches", 0) > 0)
    row = {"phase": "cli", "rc": proc.returncode,
           "seconds": time.perf_counter() - t0, "summary": summary,
           "ok": ok}
    if not ok:
        row["stderr_tail"] = proc.stderr[-2000:]
    return row


def phase_profile(torch, *, ticks: int = 20) -> dict:
    """Where a serving tick's device time goes, at the flagship width: the
    cold program (prefill of a full 64-row batch) and the warm program
    (one incremental step of 64 rows), each timed with CUDA events and
    broken down by kernel with ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.env.trading import obs_dim
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.precision import policy_from_config
    from sharetrade_tpu_torch.serve.driver import make_sessions

    cfg = FrameworkConfig().apply_overrides(FLAGSHIP)
    window, batch = cfg.env.window, cfg.serve.max_batch
    prices = PriceDataService(config=cfg.data).request("MSFT").series.prices
    model = build_model(cfg.model, obs_dim(window), device="cuda")
    policy = policy_from_config(cfg.precision)
    params = policy.cast_compute(
        model.init(torch.Generator().manual_seed(cfg.seed)))
    sessions = make_sessions(prices, window, batch, seed=cfg.seed)
    obs = torch.from_numpy(
        np.stack([s.observation() for s in sessions])).cuda()
    row = {"phase": "profile", "batch": batch}
    with torch.inference_mode():
        _, carry = model.apply_prefill(params, obs)
        programs = {
            "cold": lambda: model.apply_prefill(params, obs),
            "warm": lambda: model.apply_serve_batch(
                params, obs, {k: v.clone() for k, v in carry.items()}),
        }
        for name, fn in programs.items():
            row[f"{name}_tick_ms"] = _time_ms(torch, fn, iters=ticks)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(ticks):
                    fn()
                torch.cuda.synchronize()
            stats = []
            for ev in prof.key_averages():
                # Device-side events only: the kernels themselves (the
                # host-side aten events would count their time again).
                if not str(ev.device_type).endswith("CUDA"):
                    continue
                dev_us = getattr(ev, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = getattr(ev, "self_cuda_time_total", 0.0)
                if dev_us > 0:
                    stats.append((dev_us, ev.key, ev.count))
            stats.sort(reverse=True)
            total = sum(us for us, _, _ in stats)
            row[f"{name}_device_ms_per_tick"] = total / ticks / 1e3
            row[f"{name}_top"] = [
                {"kernel": key[:90], "ms_per_tick": us / ticks / 1e3,
                 "share": us / total if total else 0.0,
                 "calls_per_tick": count / ticks}
                for us, key, count in stats[:10]]
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--phases", default=",".join(PHASES),
                        help=f"comma list of {PHASES + EXTRA_PHASES} "
                             f"(default: {','.join(PHASES)})")
    args = parser.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES) - set(EXTRA_PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "port on a GPU and has nothing to run without one",
              file=sys.stderr)
        return 1
    import sharetrade_tpu_torch  # noqa: F401 — fails outside a checkout

    print(_nvidia_smi(), flush=True)
    results: dict = {}
    if "build" in phases:
        _print(phase_build())
    if "kernels" in phases:
        results["kernels"] = phase_kernels(torch)
        for row in results["kernels"]:
            _print(row)
        bad = [r["case"] for r in results["kernels"] if not r["ok"]]
        if bad:
            print(f"chip_smoke: flash_fwd disagrees with its plain version "
                  f"in {bad}", file=sys.stderr)
            return 1
    if "serve" in phases:
        results["serve"] = phase_serve(torch)
        _print(results["serve"])
        if results["serve"]["problems"]:
            print(f"chip_smoke: main path failed: "
                  f"{results['serve']['problems']}", file=sys.stderr)
            return 1
    if "cli" in phases:
        row = phase_cli()
        _print(row)
        if not row["ok"]:
            print("chip_smoke: cli serve failed", file=sys.stderr)
            return 1
    if "profile" in phases:
        _print(phase_profile(torch))
    if "kernels" in phases and "serve" in phases:
        _print(kernels_line(results))
    _print({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
