#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``sharetrade_tpu_torch``) on one GPU.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --phases build,kernels

Phases, in order (any failure exits non-zero before the final line):

1. device    — refuse to run without CUDA; print the card's name and power
               limit as ``nvidia-smi`` reports them.
2. build     — compile every CUDA source of the package (one ``nvcc`` per
               source, all started together); print the build time and each
               kernel's registers, spill bytes and static shared memory
               from the ``-Xptxas -v`` log (``flash_bwd_dq_wgmma``'s per
               head dim and cluster size on their own).
3. kernels   — hold each kernel against its plain PyTorch version (computed
               in float32 from the same inputs) at the shapes the main paths
               give it and the other shapes its TPU counterparts served;
               time kernel, plain version and the library yardstick with
               CUDA events (median device time, L2 flushed before every
               launch, the host one call ahead of the device); then, untimed,
               the bf16 edge cases (T < 64 and ragged T, window 1, D = 64,
               non-causal tq != tk, B*H > 64); print one JSON line per case
               (``flash_bwd_dq``'s with the cluster size it launched and
               whether a second call gave the same bits).
4. train     — the training main path: PPO on the flagship episode
               transformer at full width (512 agents, unroll 1024, L=2,
               H=2, Dh=128, window 201, bf16_mixed, adagrad), seeded random
               weights and synthetic prices, two chunks. Kernel launch
               counts are reset just before and read after each chunk; the
               second chunk is broken down with CUDA events (trunk, rollout
               loop, GAE, replay forward/backward, update); then one
               minibatch's replayed log-probabilities and values, loss
               terms and gradients through the kernels are held against
               the same minibatch through the plain attention, both
               measured against the fp32 model (see MB_FACTOR).
5. serve     — the serving main path: the serving engine on the same model
               (max_batch 64, slots 256), driven in closed loop through a
               warm phase and an eviction phase. Counts reset just before
               and read just after; the first cold batch's logits are held
               against the same batch through the plain attention.
6. cli       — ``python -m sharetrade_tpu_torch.cli serve`` for a few seconds.
7. cli_train — ``python -m sharetrade_tpu_torch.cli train`` on the flagship
               config with a 2,249-price series (one 2-chunk episode).

Opt-in: ``profile`` (a serving device-time breakdown).

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

PHASES = ("build", "kernels", "train", "serve", "cli", "cli_train")
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

#: Backward kernels against the plain backward computed in float32 from the
#: same inputs (lse and delta from the plain forward), on dq, dk and dv.
#: float32: |err| <= 5e-5 + 1e-5 * |ref| (the same f32 products summed in
#: another order over up to 8,192 rows). bfloat16: the kernels round dS
#: (and P for dV) to bf16 before their products, as the TPU kernels do, and
#: round their outputs to bf16; on random inputs of unit scale that alone
#: moves a gradient by up to ~1.5e-2 from the float32 reference, the same
#: for the plain backward run in bf16 on the same inputs (which makes the
#: same roundings). So a bf16 kernel passes when its largest error against
#: the float32 reference is at most twice the plain bf16 backward's
#: largest error, plus 1e-3 (the check FlashAttention's own tests make).
BWD_ATOL_F32, BWD_RTOL_F32 = 5e-5, 1e-5
BWD_BF16_FACTOR, BWD_BF16_ATOL = 2.0, 1e-3

#: fused_update against its plain version on the same leaves: the kernel
#: uses IEEE 1/sqrt where the plain adagrad uses torch.rsqrt (within 2 ulp
#: on the card), which moves a master by at most about one ulp; adam and
#: sgd round every operation identically.
UPDATE_ATOL, UPDATE_RTOL = 1e-6, 1e-6

#: One PPO minibatch of the flagship, three ways on the card: the bf16 model
#: through the kernels, the bf16 model through the plain attention, and the
#: fp32 model through the plain attention (the reference). For the replayed
#: log-probabilities and values (largest absolute error), each gradient
#: leaf (L2 norm of the error) and the value and entropy terms, the kernel
#: path's error against the reference must be at most MB_FACTOR times the
#: plain bf16 path's, plus MB_FLOOR times the reference's own size (max
#: |x|, the leaf's L2 norm, |term|): both bf16 paths share every rounding
#: outside the attention, so a fault in the attention shows as an error well
#: past the plain path's. The policy term sits near 0 (ratios ~1 on
#: normalised advantages), so it is held by the bound its formula gives: the
#: clipped surrogate moves by at most |adv| * |ratio change| per step, so
#: the kernel and plain terms may differ by at most the active mean of
#: |adv| * |ratio_kernel - ratio_plain| (plus MB_POLICY_SLACK for the f32
#: sums), with the ratios taken from the log-probabilities checked above.
MB_FACTOR = 2.0
MB_FLOOR = 2.0 ** -8
MB_POLICY_SLACK = 1e-6

#: The training main path: ppo_tr_episode_b512_u1024_bf16
#: (benchmarks/run_all.py) at full width, depth and width uncut.
FLAGSHIP_TRAIN = [
    "learner.algo=ppo", "model.kind=transformer", "model.seq_mode=episode",
    "model.num_layers=2", "model.num_heads=2", "model.head_dim=128",
    "env.window=201", "precision.mode=bf16_mixed",
    "parallel.num_workers=512", "learner.unroll_len=1024",
    "runtime.chunk_steps=1024",
]
TRAIN_CHUNKS = 2


def _print(obj) -> None:
    print(json.dumps(obj), flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_L2_FLUSH: list = []


#: GPU cycles of the sleep queued ahead of a timed call (about 1 ms).
_HOST_AHEAD_CYCLES = 2_000_000


def _time_ms(torch, fn, *, warmup: int = 3, iters: int = 25,
             host_ahead: bool = True) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event-timed runs,
    each after writing 128 MB (the 50 MB L2 flushed, outside the timing).

    With ``host_ahead`` a ~1 ms GPU sleep is queued before the start event,
    so the host has enqueued ``fn``'s launches before the timer starts and
    the time is the device's alone (a call whose host side takes longer than
    the sleep still shows the excess). Without it, the time includes the
    host's enqueueing whenever the host is the slower side (the serving
    ticks of the profile phase, which are host-bound)."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.empty(32 * 2 ** 20, dtype=torch.float32,
                                     device="cuda"))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        _L2_FLUSH[0].zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if host_ahead:
            torch.cuda._sleep(_HOST_AHEAD_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _bound(nbytes: float, ops: float, dname: str) -> dict:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dname] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def _band_pairs(t: int, window: int | None) -> int:
    """(row, key) pairs a causal band of width ``window`` holds."""
    w = t if window is None else min(window, t)
    return sum(min(r + 1, w) for r in range(t))


def _demangle(names: list[str]) -> list[str]:
    """``kernel<args>`` for each mangled name (``c++filt`` where it exists;
    else the mangled name)."""
    import re
    import shutil
    tool = shutil.which("c++filt")
    if not tool or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    short = []
    for full in out:
        full = full.replace("(anonymous namespace)::", "")
        m = re.match(r"(?:void )?(?:\w+::)*(\w+(?:<[^(]*>)?)\(", full)
        short.append(m.group(1) if m else full)
    return short if len(short) == len(names) else names


def phase_build() -> dict:
    from sharetrade_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    per_source = cuda_build.build_all()
    seconds = time.perf_counter() - t0
    resources = {}
    for name in cuda_build.sources():
        usage = cuda_build.kernel_resources(name)
        for short, info in zip(_demangle(list(usage)), usage.values()):
            resources[f"{name}:{short}"] = info
    # flash_bwd_dq's bf16 kernel per <head_dim, cluster size>.
    dq_wgmma = {key.split(":", 1)[1]: {
        k: info.get(k) for k in ("registers", "spill_stores", "spill_loads",
                                 "stack")}
        for key, info in resources.items()
        if key.startswith("flash_bwd:flash_bwd_dq_wgmma")}
    return {"phase": "build", "seconds": seconds, "sources": per_source,
            "nvcc": cuda_build.nvcc_path(), "flash_bwd_dq_wgmma": dq_wgmma,
            "ptxas": resources}


def _host_us(torch, fn, calls: int = 50) -> float:
    """Host microseconds to enqueue one call of ``fn`` (the wrapper's
    checks, the tensor-map encoding, the launch), with the device held busy
    by a sleep so no call waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50 * _HOST_AHEAD_CYCLES)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def check_flash_fwd(torch, *, name: str, batch: int, heads: int, seq: int,
                    head_dim: int, window: int | None, dtype,
                    causal: bool = True, kv_len: int | None = None,
                    timed: bool = True) -> dict:
    import torch.nn.functional as F

    from sharetrade_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(seq * 131 + head_dim)
    shape = (batch, heads, seq, head_dim)
    kv_shape = (batch, heads, kv_len or seq, head_dim)
    q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(kv_shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = head_dim ** -0.5
    before = attention.launch_counts["flash_fwd"]
    out, lse = attention.flash_fwd(q, k, v, causal=causal, sm_scale=scale,
                                   window=window)
    torch.cuda.synchronize()
    ref_out, ref_lse = attention._plain_forward(
        q.float(), k.float(), v.float(), causal, scale, window)
    dname = str(dtype).removeprefix("torch.")
    diff = (out.float() - ref_out).abs()
    err = diff.max().item()
    within = bool((diff <= ATOL[dname] + RTOL[dname] * ref_out.abs()).all())
    lse_err = (lse - ref_lse).abs().max().item()
    ok = (within and lse_err <= LSE_ATOL[dname]
          and bool(torch.isfinite(out).all()))
    row = {
        "phase": "kernels", "kernel": "flash_fwd", "case": name,
        "shape": list(shape), "kv_len": kv_shape[2], "causal": causal,
        "window": window, "dtype": dname, "max_abs_err": err,
        "tolerance": {"atol": ATOL[dname], "rtol": RTOL[dname]},
        "lse_max_abs_err": lse_err, "lse_tolerance": LSE_ATOL[dname],
        "launches": attention.launch_counts["flash_fwd"] - before, "ok": ok,
    }
    if not timed:
        return row

    kernel_fn = lambda: attention.flash_fwd(  # noqa: E731
        q, k, v, causal=causal, sm_scale=scale, window=window)
    kernel_ms = _time_ms(torch, kernel_fn)
    kernel_call_ms = _time_ms(torch, kernel_fn, host_ahead=False)
    plain_ms = _time_ms(torch, lambda: attention._plain_forward(
        q, k, v, causal, scale, window), iters=10)
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
    row.update({
        "kernel_ms": kernel_ms, "kernel_call_ms": kernel_call_ms,
        "host_us_per_call": _host_us(torch, kernel_fn),
        "plain_ms": plain_ms,
        "library_ms": library_ms, **_bound(nbytes, ops, dname)})
    return row


def check_flash_bwd(torch, *, name: str, batch: int, heads: int, seq: int,
                    head_dim: int, window: int | None, dtype,
                    causal: bool = True, kv_len: int | None = None,
                    timed: bool = True) -> list[dict]:
    """flash_bwd_dq and flash_bwd_dkv against the plain backward in float32
    from the same inputs; one row per kernel."""
    import torch.nn.functional as F

    from sharetrade_tpu_torch.ops import attention

    gen = torch.Generator(device="cuda").manual_seed(seq * 17 + head_dim)
    shape = (batch, heads, seq, head_dim)
    kv_shape = (batch, heads, kv_len or seq, head_dim)
    q, dout = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
               for _ in range(2))
    k, v = (torch.randn(kv_shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = head_dim ** -0.5
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    out, lse = attention._plain_forward(qf, kf, vf, causal, scale, window)
    delta = (df * out).sum(dim=-1)
    kw = dict(causal=causal, sm_scale=scale, window=window)
    before = dict(attention.launch_counts)
    dq = attention.flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = attention.flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    before_repeat = attention.launch_counts["flash_bwd_dq"]
    torch.cuda.synchronize()
    ref = attention._plain_backward(qf, kf, vf, df, lse, delta, causal, scale,
                                    window)
    dname = str(dtype).removeprefix("torch.")
    if dtype == torch.float32:
        tolerance = {"atol": BWD_ATOL_F32, "rtol": BWD_RTOL_F32}
        plain_err = [0.0, 0.0, 0.0]
    else:
        plain = attention._plain_backward(q, k, v, dout, lse, delta, causal,
                                          scale, window)
        plain_err = [(p.float() - r).abs().max().item()
                     for p, r in zip(plain, ref)]
        del plain
        tolerance = {"factor_of_plain_bf16_err": BWD_BF16_FACTOR,
                     "atol": BWD_BF16_ATOL, "plain_bf16_err": plain_err}

    def err(got, want, j):
        diff = (got.float() - want).abs()
        worst = diff.max().item()
        if dtype == torch.float32:
            ok = bool((diff <= BWD_ATOL_F32 + BWD_RTOL_F32 * want.abs()).all())
        else:
            ok = worst <= BWD_BF16_FACTOR * plain_err[j] + BWD_BF16_ATOL
        return worst, ok and bool(torch.isfinite(got).all())

    common = {"phase": "kernels", "case": name, "shape": list(shape),
              "kv_len": kv_shape[2], "causal": causal, "window": window,
              "dtype": dname, "tolerance": tolerance}
    e_dq, ok_dq = err(dq, ref[0], 0)
    # dQ's sums run in a fixed order (bf16: a cluster's partial sums in
    # rank order), so a second call gives the same bits.
    repeat_equal = torch.equal(
        dq, attention.flash_bwd_dq(q, k, v, dout, lse, delta, **kw))
    ok_dq = ok_dq and repeat_equal
    e_dk, ok_dk = err(dk, ref[1], 1)
    e_dv, ok_dv = err(dv, ref[2], 2)
    rows = [{**common, "kernel": "flash_bwd_dq", "max_abs_err": e_dq,
             "launches": before_repeat - before["flash_bwd_dq"],
             "repeat_bitwise": repeat_equal, "ok": ok_dq,
             "cluster": attention.flash_bwd_dq_cluster(
                 q, k, causal=causal, window=window)},
            {**common, "kernel": "flash_bwd_dkv",
             "max_abs_err": max(e_dk, e_dv),
             "launches": attention.launch_counts["flash_bwd_dkv"]
             - before["flash_bwd_dkv"], "ok": ok_dk and ok_dv}]
    if not timed:
        return rows

    # The library yardstick: SDPA with the band mask. Its backward alone
    # (one forward kept, autograd.grad timed with retain_graph) is the same
    # function as the two kernels together; forward + backward is kept
    # beside it.
    idx = torch.arange(seq, device="cuda")
    band = idx[None, :] <= idx[:, None]
    if window is not None:
        band = band & (idx[None, :] > idx[:, None] - window)
    qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def library_fwd_bwd():
        o = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=band,
                                           scale=scale)
        torch.autograd.grad(o, (qg, kg, vg), dout)

    lib_out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=band,
                                             scale=scale)
    library_bwd_ms = _time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (qg, kg, vg), dout, retain_graph=True), iters=10)
    library_fwd_bwd_ms = _time_ms(torch, library_fwd_bwd, iters=10)
    del lib_out
    elem = q.element_size()
    pairs = batch * heads * _band_pairs(seq, window)
    rows_bytes = 2 * batch * heads * seq * 4            # lse, delta
    library = {"library_bwd_ms": library_bwd_ms,
               "library_fwd_bwd_ms": library_fwd_bwd_ms,
               "library": "SDPA with the band mask: backward alone "
                          "(library_bwd_ms), forward + backward "
                          "(library_fwd_bwd_ms); both kernels together"}
    dq_fn = lambda: attention.flash_bwd_dq(  # noqa: E731
        q, k, v, dout, lse, delta, **kw)
    dkv_fn = lambda: attention.flash_bwd_dkv(  # noqa: E731
        q, k, v, dout, lse, delta, **kw)
    rows[0].update({
        **library, "kernel_ms": _time_ms(torch, dq_fn),
        "kernel_call_ms": _time_ms(torch, dq_fn, host_ahead=False),
        "host_us_per_call": _host_us(torch, dq_fn),
        "plain_ms": _time_ms(torch, lambda: attention._plain_dq(
            q, k, v, dout, lse, delta, causal, scale, window), iters=10),
        # q, k, v, dO read, dQ written; S, dP, dQ products.
        **_bound(5 * q.numel() * elem + rows_bytes, 6 * head_dim * pairs,
                 dname)})
    rows[1].update({
        **library, "kernel_ms": _time_ms(torch, dkv_fn),
        "kernel_call_ms": _time_ms(torch, dkv_fn, host_ahead=False),
        "host_us_per_call": _host_us(torch, dkv_fn),
        "plain_ms": _time_ms(torch, lambda: attention._plain_dkv(
            q, k, v, dout, lse, delta, causal, scale, window), iters=10),
        # q, k, v, dO read, dK, dV written; S, dP, dV, dK products.
        **_bound(6 * q.numel() * elem + rows_bytes, 8 * head_dim * pairs,
                 dname)})
    return rows


def _flagship_params(torch):
    """The flagship model's parameter tree on the card (34 leaves)."""
    from sharetrade_tpu_torch.models.transformer_episode import (
        episode_transformer_policy)
    model = episode_transformer_policy(203, 3, num_layers=2, num_heads=2,
                                       head_dim=128, device="cuda")
    return model.init(torch.Generator().manual_seed(0))


def check_fused_update(torch, *, name: str, optimizer: str, grad_dtype,
                       emit: bool = False) -> dict:
    """fused_update over the flagship's leaf set against the plain per-leaf
    math on the same leaves, one step from a state three steps in; with
    ``emit`` the bf16 compute copy it writes must be the exact recast of
    the new masters."""
    from sharetrade_tpu_torch.models.core import tree_leaves
    from sharetrade_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(len(name))
    params = tree_leaves(_flagship_params(torch))
    grads = [(torch.randn(p.shape, generator=gen, device="cuda") * 0.05)
             .to(grad_dtype) for p in params]
    n_state = {"adagrad": 1, "adam": 2, "sgd": 0}[optimizer]
    state = [[torch.rand(p.shape, generator=gen, device="cuda") * 0.01
              + (0.1 if optimizer == "adagrad" else 0.0) for p in params]
             for _ in range(n_state)]
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    _, bias = fu.adam_bias(count)
    bias = bias if optimizer == "adam" else None

    def clone(leaves):
        return [x.clone() for x in leaves]

    def emitted():
        return ([torch.empty_like(p, dtype=torch.bfloat16) for p in params]
                if emit else None)

    p_k, s_k, c_k = clone(params), [clone(x) for x in state], emitted()
    before = fu.launch_counts["fused_update"]
    fu.fused_update(optimizer, 0.01, p_k, grads, s_k, bias=bias, compute=c_k)
    launches = fu.launch_counts["fused_update"] - before
    torch.cuda.synchronize()
    ok = not emit or all(torch.equal(c, p.to(torch.bfloat16))
                         for c, p in zip(c_k, p_k))
    errs = []
    for i, p in enumerate(params):
        p_ref, s_ref = fu._plain_leaf(optimizer, 0.01, p, grads[i],
                                      [x[i] for x in state], bias)
        for got, want in [(p_k[i], p_ref)] + [
                (s_k[j][i], s_ref[j]) for j in range(n_state)]:
            diff = (got - want).abs()
            errs.append(diff.max().item())
            ok = ok and bool((diff <= UPDATE_ATOL
                              + UPDATE_RTOL * want.abs()).all())

    p_t, s_t, c_t = clone(params), [clone(x) for x in state], emitted()
    kernel_fn = lambda: fu.fused_update(  # noqa: E731
        optimizer, 0.01, p_t, grads, s_t, bias=bias, compute=c_t)
    kernel_ms = _time_ms(torch, kernel_fn)
    kernel_call_ms = _time_ms(torch, kernel_fn, host_ahead=False)

    def plain():
        for i, p in enumerate(p_t):
            p_new, _ = fu._plain_leaf(optimizer, 0.01, p, grads[i],
                                      [x[i] for x in s_t], bias)
            if emit:
                p_new.to(torch.bfloat16)

    plain_ms = _time_ms(torch, plain, iters=10)
    lib_params = [torch.nn.Parameter(p.clone()) for p in params]
    for lp, g in zip(lib_params, grads):
        lp.grad = g.float()
    if optimizer == "adagrad":
        opt = torch.optim.Adagrad(lib_params, lr=0.01,
                                  initial_accumulator_value=0.1, eps=1e-7,
                                  foreach=True)
    elif optimizer == "adam":
        opt = torch.optim.Adam(lib_params, lr=0.01, fused=True)
    else:
        opt = torch.optim.SGD(lib_params, lr=0.01, foreach=True)
    library_ms = _time_ms(torch, opt.step, iters=10)

    n = sum(p.numel() for p in params)
    g_bytes = grads[0].element_size()
    # p read + written, g read, each moment read + written, the bf16 copy
    # written.
    nbytes = n * (8 + g_bytes + 8 * n_state + (2 if emit else 0))
    flops = n * {"adagrad": 7, "adam": 16, "sgd": 2}[optimizer]
    return {"phase": "kernels", "kernel": "fused_update", "case": name,
            "optimizer": optimizer,
            "grad_dtype": str(grad_dtype).removeprefix("torch."),
            "emit_compute": emit,
            "leaves": len(params), "parameters": n,
            "max_abs_err": max(errs),
            "tolerance": {"atol": UPDATE_ATOL, "rtol": UPDATE_RTOL},
            "kernel_ms": kernel_ms, "kernel_call_ms": kernel_call_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library": type(opt).__name__ + (
                " (fused)" if optimizer == "adam" else " (foreach)"),
            **_bound(nbytes, flops, "float32"),
            "launches": launches, "ok": ok}


def phase_kernels(torch) -> list[dict]:
    fwd_cases = [
        # The serving shape: a cold batch of 64 sessions, 2 heads, the
        # (L-1)*(W-1) + W = 401-tick prefill, band 201.
        dict(name="serving_bf16", batch=64, heads=2, seq=401, head_dim=128,
             window=201, dtype=torch.bfloat16),
        dict(name="serving_f32", batch=64, heads=2, seq=401, head_dim=128,
             window=201, dtype=torch.float32),
        # The training path: the rollout trunk (B = 1 representative, hist
        # 200 + window 201 + unroll 1024 = 1,425 ticks) and the replay
        # forward (1,424 ticks), band 201.
        dict(name="trunk_bf16", batch=1, heads=2, seq=1425, head_dim=128,
             window=201, dtype=torch.bfloat16),
        dict(name="replay_bf16", batch=1, heads=2, seq=1424, head_dim=128,
             window=201, dtype=torch.bfloat16),
        # The shape class the TPU's streaming kernel (K2) served.
        dict(name="long_banded_bf16", batch=2, heads=2, seq=8192,
             head_dim=128, window=201, dtype=torch.bfloat16),
        dict(name="causal_f32", batch=8, heads=4, seq=256, head_dim=64,
             window=None, dtype=torch.float32),
    ]
    bwd_cases = [
        # The training replay: B = 1 representative, 2 heads, hist 200 +
        # window 201 + unroll 1024 - 1 = 1,424 ticks, band 201.
        dict(name="replay_bf16", batch=1, heads=2, seq=1424, head_dim=128,
             window=201, dtype=torch.bfloat16),
        dict(name="replay_f32", batch=1, heads=2, seq=1424, head_dim=128,
             window=201, dtype=torch.float32),
        # The shape class of the TPU's streaming backward (K5/K6).
        dict(name="long_banded_bf16", batch=2, heads=2, seq=8192,
             head_dim=128, window=201, dtype=torch.bfloat16),
        dict(name="causal_f32", batch=8, heads=4, seq=256, head_dim=64,
             window=None, dtype=torch.float32),
    ]
    update_cases = [
        # The training path's case: adagrad, bf16 grads, and the next bf16
        # compute copy written by the same pass.
        dict(name="adagrad_bf16", optimizer="adagrad",
             grad_dtype=torch.bfloat16, emit=True),
        dict(name="adam_f32", optimizer="adam", grad_dtype=torch.float32),
        dict(name="sgd_bf16", optimizer="sgd", grad_dtype=torch.bfloat16),
    ]
    bf16 = torch.bfloat16
    # Corners of the bf16 (wgmma + TMA) kernels, held and not timed: shorter
    # than one tile, ragged tiles, each row seeing only itself, D = 64,
    # non-causal with tq != tk, more than 64 heads in the grid, and a plain
    # causal band of up to 8 key tiles (flash_bwd_dq over a cluster of 2).
    edge_cases = [
        dict(name="t37_d64", batch=1, heads=1, seq=37, head_dim=64,
             window=None, dtype=bf16),
        dict(name="t130_window1", batch=2, heads=2, seq=130, head_dim=128,
             window=1, dtype=bf16),
        dict(name="t401_d64", batch=1, heads=2, seq=401, head_dim=64,
             window=201, dtype=bf16),
        dict(name="cross_100x257", batch=2, heads=2, seq=100, head_dim=64,
             window=None, dtype=bf16, causal=False, kv_len=257),
        dict(name="bh80_t130", batch=40, heads=2, seq=130, head_dim=128,
             window=None, dtype=bf16),
        # Plain causal over 8 query tiles: rank 0 of a pair walks 4 tiles.
        dict(name="t512_causal", batch=1, heads=2, seq=512, head_dim=128,
             window=None, dtype=bf16),
    ]
    rows = [check_flash_fwd(torch, **case) for case in fwd_cases]
    for case in bwd_cases:
        rows += check_flash_bwd(torch, **case)
    for case in edge_cases:
        rows.append(check_flash_fwd(torch, **case, timed=False))
        rows += check_flash_bwd(torch, **case, timed=False)
    rows += [check_fused_update(torch, **case) for case in update_cases]
    return rows


FLAGSHIP = [
    # ppo_tr_episode_b512_u1024_bf16 (benchmarks/run_all.py), served.
    "model.kind=transformer", "model.seq_mode=episode",
    "model.num_layers=2", "model.num_heads=2", "model.head_dim=128",
    "env.window=201", "precision.mode=bf16_mixed",
    "serve.max_batch=64", "serve.slots=256",
]


#: Every kernel of the port: its source, the Pallas kernels it replaces and
#: its design per input dtype (the wrappers dispatch by dtype).
_WGMMA = {"bfloat16": "wgmma+tma", "float32": "simt"}
KERNELS = {
    "flash_fwd": ("sharetrade_tpu_torch/csrc/flash_fwd.cu",
                  "sharetrade_tpu/ops/attention.py:88",
                  ["sharetrade_tpu/ops/attention.py:284"], _WGMMA),
    "flash_bwd_dq": ("sharetrade_tpu_torch/csrc/flash_bwd.cu",
                     "sharetrade_tpu/ops/attention.py:375",
                     ["sharetrade_tpu/ops/attention.py:476"],
                     {"bfloat16": "wgmma+tma+cluster", "float32": "simt"}),
    "flash_bwd_dkv": ("sharetrade_tpu_torch/csrc/flash_bwd.cu",
                      "sharetrade_tpu/ops/attention.py:423",
                      ["sharetrade_tpu/ops/attention.py:514"], _WGMMA),
    "fused_update": ("sharetrade_tpu_torch/csrc/fused_update.cu",
                     "sharetrade_tpu/ops/fused_update.py:102", [],
                     {"bfloat16": "elementwise", "float32": "elementwise"}),
}
#: The kernels-phase case each kernel's line reports: the main paths' shape.
KERNEL_CASE = {"flash_fwd": "serving_bf16", "flash_bwd_dq": "replay_bf16",
               "flash_bwd_dkv": "replay_bf16",
               "fused_update": "adagrad_bf16"}


def kernels_line(results: dict) -> dict:
    """Every kernel of the port, with the Pallas kernels it replaces, the
    numbers of its main-path case and its launches on the main paths (the
    train and serve runs, each counted from 0). ``library_ms`` of the
    backward kernels is SDPA's backward alone; ``design`` is the kernel's
    design for each input dtype."""
    entries = []
    for name, (source, replaces, also, design) in KERNELS.items():
        row = next(r for r in results["kernels"]
                   if r["kernel"] == name and r["case"] == KERNEL_CASE[name])
        by_path = {path: results[path]["launches"].get(name, 0)
                   for path in ("train", "serve") if path in results}
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "also_replaces": also,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row.get("library_bwd_ms", row.get("library_ms")),
            "case": row["case"], "design": design,
        })
    return {"kernels": entries}


def _all_launch_counts() -> dict:
    from sharetrade_tpu_torch.ops import attention, fused_update
    return {**attention.launch_counts, **fused_update.launch_counts}


def _reset_launch_counts() -> None:
    from sharetrade_tpu_torch.ops import attention, fused_update
    attention.reset_launch_counts()
    fused_update.reset_launch_counts()


def _minibatch_check(torch, cfg, env, agent, ts) -> dict:
    """One PPO minibatch (agents 0..127 of a fresh rollout from ``ts``)
    through the kernels, through the plain attention and through the fp32
    model, held as the MB_* constants state."""
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.agents.rollout import (
        collect_rollout, gae_advantages, normalize_advantages_masked,
        replay_forward)
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.ops import attention
    from sharetrade_tpu_torch.precision import policy_from_config

    def plain_agent(c):
        sm_scale = c.model.head_dim ** -0.5
        model = build_model(
            c.model, env.obs_dim, device="cuda",
            attention_fn=lambda q, k, v, w: attention.reference_attention(
                q, k, v, causal=True, sm_scale=sm_scale, local_window=w))
        return build_agent(c, env, model, device="cuda")

    compute = policy_from_config(cfg.precision).cast_compute(ts.params)
    _, traj, bootstrap, init_carry = collect_rollout(
        agent.model, env, ts, cfg.runtime.chunk_steps,
        cfg.parallel.num_workers, params=compute)
    idx = torch.arange(cfg.parallel.num_workers // cfg.learner.ppo_minibatches,
                       device="cuda")
    with torch.no_grad():
        adv = gae_advantages(traj.reward, traj.value, traj.active, bootstrap,
                             cfg.learner.gamma, cfg.learner.gae_lambda)
        ret = (adv + traj.value).index_select(1, idx)
        adv = adv.index_select(1, idx)
    traj = traj.take(idx)
    carry = {k: v.index_select(0, idx) for k, v in init_carry.items()}
    carry32 = {k: v.float() if v.is_floating_point() else v
               for k, v in carry.items()}
    cfg32 = FrameworkConfig().apply_overrides(
        FLAGSHIP_TRAIN + ["precision.mode=fp32"])
    paths = {"kernel": (agent, compute, carry),
             "plain": (plain_agent(cfg), compute, carry),
             "fp32": (plain_agent(cfg32), ts.params, carry32)}
    got = {}
    for name, (ag, params, c) in paths.items():
        with torch.no_grad():
            logits, values, _ = replay_forward(ag.model, params, traj, c)
            logp = torch.log_softmax(logits.float(), dim=-1).gather(
                -1, traj.action[..., None])[..., 0]
        terms, grads = ag.minibatch_grads(params, traj, c, adv, ret)
        got[name] = {"logp": logp, "value": values.float(),
                     "terms": terms.float(),
                     "grads": [g.float() for g in grads]}
    ref = got["fp32"]

    def errs(path):
        g = got[path]
        return {"logp": (g["logp"] - ref["logp"]).abs().max().item(),
                "value": (g["value"] - ref["value"]).abs().max().item(),
                "value_loss": abs(g["terms"][2] - ref["terms"][2]).item(),
                "entropy": abs(g["terms"][3] - ref["terms"][3]).item(),
                "grads": [(a - b).norm().item()
                          for a, b in zip(g["grads"], ref["grads"])]}

    size = {"logp": ref["logp"].abs().max().item(),
            "value": ref["value"].abs().max().item(),
            "value_loss": abs(ref["terms"][2]).item(),
            "entropy": abs(ref["terms"][3]).item(),
            "grads": [g.norm().item() for g in ref["grads"]]}
    e_k, e_p = errs("kernel"), errs("plain")
    failed = []
    for key in ("logp", "value", "value_loss", "entropy", "grads"):
        triples = (zip(e_k[key], e_p[key], size[key]) if key == "grads"
                   else [(e_k[key], e_p[key], size[key])])
        for j, (ek, ep, sz) in enumerate(triples):
            if not ek <= MB_FACTOR * ep + MB_FLOOR * sz:
                failed.append(key if key != "grads" else f"grad leaf {j}")

    weight = traj.active
    denom = torch.clamp(weight.sum(), min=1.0)
    ratio = {k: torch.exp(got[k]["logp"] - traj.logp)
             for k in ("kernel", "plain")}
    policy_bound = ((normalize_advantages_masked(adv, weight, denom).abs()
                     * (ratio["kernel"] - ratio["plain"]).abs()
                     * weight).sum() / denom).item() + MB_POLICY_SLACK
    policy_diff = abs(got["kernel"]["terms"][1]
                      - got["plain"]["terms"][1]).item()
    if not policy_diff <= policy_bound:
        failed.append("policy term")
    gk, gp = got["kernel"]["grads"], got["plain"]["grads"]
    leaf_rel = [((a - b).norm() / b.norm()).item() for a, b in zip(gk, gp)]
    return {
        "agents": len(idx),
        "kernel_err_vs_fp32": e_k, "plain_err_vs_fp32": e_p,
        "fp32_size": size,
        "kernel_vs_plain": {
            "logp_max_abs": (got["kernel"]["logp"]
                             - got["plain"]["logp"]).abs().max().item(),
            "terms": [got["kernel"]["terms"].tolist(),
                      got["plain"]["terms"].tolist()],
            "grad_leaf_rel_l2_max": max(leaf_rel),
            "grad_leaf_rel_l2_median": statistics.median(leaf_rel)},
        "policy_term_diff": policy_diff, "policy_term_bound": policy_bound,
        "rule": {"factor": MB_FACTOR, "floor": MB_FLOOR,
                 "policy_slack": MB_POLICY_SLACK},
        "failed": failed,
    }


def phase_train(torch) -> dict:
    """The training main path; see the module docstring."""
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.env.trading import make_trading_env
    from sharetrade_tpu_torch.models.core import tree_leaves

    cfg = FrameworkConfig().apply_overrides(FLAGSHIP_TRAIN)
    prices = PriceDataService(config=cfg.data).request("MSFT").series.prices
    env = make_trading_env(prices, window=cfg.env.window,
                           initial_budget=cfg.env.initial_budget,
                           initial_shares=cfg.env.initial_shares,
                           device="cuda")
    agent = build_agent(cfg, env, device="cuda")
    ts = agent.init(cfg.seed)
    workers, unroll = cfg.parallel.num_workers, cfg.runtime.chunk_steps
    torch.cuda.synchronize()

    # ---- the counted window: counts reset just before, read just after.
    _reset_launch_counts()
    per_chunk, chunk_s, metrics_rows, breakdown = [], [], [], {}
    for c in range(TRAIN_CHUNKS):
        marks = []

        def marker(label, marks=marks):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((label, ev))

        before = _all_launch_counts()
        t0 = time.perf_counter()
        if c == TRAIN_CHUNKS - 1:
            marker("start")
            ts, metrics = agent.step(ts, marker=marker)
        else:
            ts, metrics = agent.step(ts)
        row = {k: float(v) for k, v in metrics.items()}   # syncs
        chunk_s.append(time.perf_counter() - t0)
        after = _all_launch_counts()
        per_chunk.append({k: after[k] - before[k] for k in after})
        metrics_rows.append(row)
        for (_, a), (label, b) in zip(marks, marks[1:]):
            breakdown[label] = breakdown.get(label, 0.0) + a.elapsed_time(b)
    torch.cuda.synchronize()
    launches = _all_launch_counts()
    # ---- end of the counted window.

    minibatch = _minibatch_check(torch, cfg, env, agent, ts)
    chunk_ms = [1e3 * t for t in chunk_s]
    total_ms = sum(breakdown.values())
    updates = cfg.learner.ppo_epochs * cfg.learner.ppo_minibatches
    layers = cfg.model.num_layers
    expect = {"flash_fwd": layers * (1 + updates),
              "flash_bwd_dq": layers * updates,
              "flash_bwd_dkv": layers * updates,
              "fused_update": updates}
    row = {
        "phase": "train", "config": FLAGSHIP_TRAIN, "chunks": TRAIN_CHUNKS,
        "agents": workers, "unroll": unroll,
        "parameters": sum(p.numel() for p in tree_leaves(ts.params)),
        "chunk_ms": chunk_ms,
        "agent_steps_per_s": workers * unroll / chunk_s[-1],
        "losses": [{k: r[k] for k in ("loss", "policy_loss", "value_loss",
                                       "entropy")} for r in metrics_rows],
        "env_steps": metrics_rows[-1]["env_steps"],
        "updates": metrics_rows[-1]["updates"],
        "launches": launches, "launches_per_chunk": per_chunk,
        "expected_per_chunk": expect,
        "breakdown_ms": breakdown,
        "breakdown_share": {k: v / total_ms for k, v in breakdown.items()},
        "minibatch": minibatch,
    }
    problems = []
    if any(c != expect for c in per_chunk):
        problems.append("kernel launches per chunk differ from the "
                        "expected counts")
    if not all(np.isfinite(list(r.values())).all() for r in metrics_rows):
        problems.append("non-finite chunk metrics")
    if minibatch["failed"]:
        problems.append("one minibatch through the kernels disagrees with "
                        f"the plain attention's: {minibatch['failed']}")
    if metrics_rows[-1]["env_steps"] != TRAIN_CHUNKS * unroll:
        problems.append("env steps do not add up")
    row["problems"] = problems
    return row


def phase_serve(torch) -> dict:
    """The serving main path; see the module docstring."""
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.env.trading import obs_dim
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.ops import attention
    from sharetrade_tpu_torch.precision import policy_from_config
    from sharetrade_tpu_torch.serve import ServeEngine
    from sharetrade_tpu_torch.serve.driver import make_sessions, run_closed_loop

    cfg = FrameworkConfig().apply_overrides(FLAGSHIP)
    window = cfg.env.window
    prices = PriceDataService(config=cfg.data).request("MSFT").series.prices
    model = build_model(cfg.model, obs_dim(window), device="cuda")
    params = model.init(torch.Generator().manual_seed(cfg.seed))
    policy = policy_from_config(cfg.precision)
    engine = ServeEngine(model, cfg.serve, params, precision=policy)
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    slots = cfg.serve.slots

    # ---- the counted window: counts reset just before, read just after.
    _reset_launch_counts()
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
    torch.cuda.synchronize()
    all_launches = _all_launch_counts()
    launches = all_launches["flash_fwd"]
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
        cfg.model, obs_dim(window), device="cuda",
        attention_fn=lambda q, k, v, w: attention.reference_attention(
            q, k, v, causal=True, sm_scale=sm_scale, local_window=w))
    with torch.inference_mode():
        ref, _ = plain_model.apply_prefill(
            policy.cast_compute(params),
            torch.from_numpy(np.stack(first_obs)).cuda())
    ref_logits = ref.logits.cpu().numpy()
    ref_values = ref.value.cpu().numpy()
    logit_err = float(np.abs(got_logits - ref_logits).max())
    value_err = float(np.abs(got_values - ref_values).max())

    row = {
        "phase": "serve", "config": FLAGSHIP, "warmup_s": warmup_s,
        "warm_phase": warm, "evict_phase": evict,
        "counters": delta, "flash_fwd_launches": launches,
        "launches": all_launches,
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


def phase_cli_train() -> dict:
    """``cli train`` as a user runs it, on the flagship config with a
    series of 2,249 prices: horizon 2,048, one episode of two chunks."""
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "train"]
    for item in FLAGSHIP_TRAIN + ["data.synthetic_length=2249"]:
        cmd += ["--set", item]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    summary = json.loads(lines[-1]) if lines else {}
    launches = summary.get("kernel_launches", {})
    ok = (proc.returncode == 0
          and np.isfinite(summary.get("avg_portfolio", float("nan")))
          and summary.get("env_steps") == 2048
          and all(launches.get(k, 0) > 0 for k in KERNELS))
    row = {"phase": "cli_train", "rc": proc.returncode,
           "seconds": time.perf_counter() - t0, "summary": summary,
           "ok": bool(ok)}
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
            row[f"{name}_tick_ms"] = _time_ms(torch, fn, iters=ticks,
                                              host_ahead=False)
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
    # Full float32 matrix products for every f32 comparison (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {}
    if "build" in phases:
        _print(phase_build())
    if "kernels" in phases:
        results["kernels"] = phase_kernels(torch)
        for row in results["kernels"]:
            _print(row)
        bad = [f"{r['kernel']}:{r['case']}" for r in results["kernels"]
               if not r["ok"]]
        if bad:
            print(f"chip_smoke: kernels disagree with their plain versions "
                  f"in {bad}", file=sys.stderr)
            return 1
    if "train" in phases:
        results["train"] = phase_train(torch)
        _print(results["train"])
        if results["train"]["problems"]:
            print(f"chip_smoke: training path failed: "
                  f"{results['train']['problems']}", file=sys.stderr)
            return 1
    if "serve" in phases:
        results["serve"] = phase_serve(torch)
        _print(results["serve"])
        if results["serve"]["problems"]:
            print(f"chip_smoke: serving path failed: "
                  f"{results['serve']['problems']}", file=sys.stderr)
            return 1
    if "cli" in phases:
        row = phase_cli()
        _print(row)
        if not row["ok"]:
            print("chip_smoke: cli serve failed", file=sys.stderr)
            return 1
    if "cli_train" in phases:
        row = phase_cli_train()
        _print(row)
        if not row["ok"]:
            print("chip_smoke: cli train failed", file=sys.stderr)
            return 1
    if "profile" in phases:
        _print(phase_profile(torch))
    if "kernels" in phases and ("serve" in phases or "train" in phases):
        _print(kernels_line(results))
    _print({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
