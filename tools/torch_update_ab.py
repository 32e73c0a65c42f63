"""``fused_update`` against the parent's kernel, on one card.

    python3 tools/torch_update_ab.py --parent DIR [--rounds 4]

Compiles ``DIR/sharetrade_tpu_torch/csrc/fused_update.cu`` with
``cuda_build``'s flags into a temporary directory and loads it with ctypes
through DIR's own wrapper (``DIR/sharetrade_tpu_torch/ops/fused_update.py``,
loaded under another name, its library pointed at that build), so the
parent's kernel is called under its own signature with its own host path.
For every ``chip_smoke.UPDATE_CASES`` case, and for leaves of odd sizes and
at odd element offsets, a gate off and on, both run on copies of the same
leaves and must give bit-equal masters, moments and compute copies. Then
each timed case is timed in turns (parent, this, this, parent, ...): the
device ms (``chip_smoke._time_ms``: L2 flushed, the host one call ahead),
the call ms (host included) and the host's µs a call
(``chip_smoke._host_us``); beside them the device ms with the L2 flushed
by reading (no dirty lines left for the kernel to write back), an empty
kernel's ms timed the same way (the launch floor), and this wrapper's host
µs with the launch stubbed out (its Python side). One JSON line per case,
then the medians. Last, each side's achieved stream rate with the launch
cost spread out (:func:`stream_rates`: updates back to back in one CUDA
graph, over leaves that do not fit in the L2), beside an empty kernel's
time a graph node and ``Tensor.copy_``'s rate.

Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _print(obj) -> None:
    print(json.dumps(obj), flush=True)


def build(src: str, lib_path: str):
    """``src`` compiled with ``cuda_build``'s flags and loaded."""
    import ctypes

    from sharetrade_tpu_torch.ops import cuda_build

    proc = subprocess.run(
        [cuda_build.nvcc_path(), *cuda_build.ARCH_FLAGS, *cuda_build.CFLAGS,
         "-o", lib_path, src], capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    return ctypes.CDLL(lib_path)


def parent_wrapper(parent: str, build_dir: str):
    """DIR's ``ops/fused_update.py`` as a module of its own, launching
    DIR's kernel built into ``build_dir``."""
    lib = build(os.path.join(parent, "sharetrade_tpu_torch", "csrc",
                             "fused_update.cu"),
                os.path.join(build_dir, "parent_fused_update.so"))
    spec = importlib.util.spec_from_file_location(
        "parent_fused_update",
        os.path.join(parent, "sharetrade_tpu_torch", "ops", "fused_update.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    module.cuda_build = types.SimpleNamespace(load=lambda name: lib)
    return module


def _run(torch, fu, optimizer, params, grads, state, bias, emit, gate=None):
    """One call of ``fu.fused_update`` on copies: (masters, moments,
    compute copy)."""
    p = [x.clone() for x in params]
    s = [[x.clone() for x in leaves] for leaves in state]
    c = ([torch.empty_like(x, dtype=torch.bfloat16) for x in params]
         if emit else None)
    fu.fused_update(optimizer, 0.01, p, grads, s, bias=bias, compute=c,
                    gate=gate)
    torch.cuda.synchronize()
    return p, s, c


def _bit_equal(torch, a, b) -> bool:
    """Masters, moments and compute copies of two runs, bit for bit."""
    pa, sa, ca = a
    pb, sb, cb = b
    pairs = list(zip(pa, pb)) + [
        (x, y) for la, lb in zip(sa, sb) for x, y in zip(la, lb)]
    if ca is not None:
        pairs += zip(ca, cb)
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in pairs)


def python_us(torch, fu, optimizer, params, grads, state, bias, emit,
              calls: int = 200) -> float:
    """This wrapper's host µs a call with the C launch stubbed out: the
    Python side alone (the rest of ``host_us`` is ctypes, the C entry point
    and ``cudaLaunchKernel``)."""
    p, s, c = _run(torch, fu, optimizer, params, grads, state, bias, emit)
    plan = next(reversed(fu._PLANS.values()))
    launch = plan.launch
    plan.launch = lambda address: 0
    try:
        t0 = time.perf_counter()
        for _ in range(calls):
            fu.fused_update(optimizer, 0.01, p, grads, s, bias=bias,
                            compute=c)
        return (time.perf_counter() - t0) / calls * 1e6
    finally:
        plan.launch = launch


def _graph_ms(torch, calls: list, replays: int) -> float:
    """Milliseconds a call of ``calls``, captured in order in one CUDA
    graph and the graph replayed ``replays`` times between two events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for call in calls:
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


def stream_rates(torch, sides: dict, *, rounds: int = 3, copies: int = 4,
                 updates: int = 64, big: int = 2 ** 26) -> dict:
    """Each side's device ms an update and achieved rate (TB/s: the bytes
    the update must move over its time) with the per-launch cost spread
    out, in turns: ``updates`` updates back to back in one CUDA graph,
    replayed. Two sets. ``flagship``: the flagship case (adagrad, bf16
    grads, writing the bf16 compute copy; 20 bytes an element) in
    ``copies`` copies taken in turn, so the 31.7 MB each update moves were
    last touched ``copies - 1`` updates (95 MB, more than the 50 MB L2)
    before. ``big_leaf``: one leaf of ``big`` elements (adagrad, f32 grads;
    20 bytes an element, 1.34 GB an update), eight updates a graph, where
    the launches are nothing beside the stream. Beside them, the same way:
    an empty kernel's ms a graph node, and ``Tensor.copy_`` of 1 GiB of f32
    (read and write: the library's copy rate on this card)."""
    case = next(c for c in chip_smoke.UPDATE_CASES
                if c["name"] == "adagrad_bf16")
    sets = []
    for k in range(copies):
        params, grads, state, _ = chip_smoke.update_inputs(torch, **case)
        params = [p.clone() for p in params]
        state = [[x.clone() for x in leaves] for leaves in state]
        compute = [torch.empty_like(p, dtype=torch.bfloat16) for p in params]
        sets.append((params, grads, state, compute))
    flagship_bytes = 20 * sum(p.numel() for p in sets[0][0])
    gen = torch.Generator(device="cuda").manual_seed(5)
    big_set = ([torch.randn(big, generator=gen, device="cuda")],
               [torch.randn(big, generator=gen, device="cuda") * 0.05],
               [[torch.full((big,), 0.1, device="cuda")]], None)
    big_bytes = 20 * big

    def calls(module, chosen, n):
        out = []
        for i in range(n):
            params, grads, state, compute = chosen[i % len(chosen)]
            out.append(lambda m=module, p=params, g=grads, s=state,
                       c=compute: m.fused_update("adagrad", 0.01, p, g, s,
                                                 compute=c))
        return out

    times = {k: {"flagship": [], "big_leaf": []} for k in sides}
    errors = {}
    for r in range(rounds):
        for k in (list(sides) if r % 2 == 0 else list(sides)[::-1]):
            if k in errors:
                continue
            try:
                times[k]["flagship"].append(
                    _graph_ms(torch, calls(sides[k], sets, updates), 10))
                times[k]["big_leaf"].append(
                    _graph_ms(torch, calls(sides[k], [big_set], 8), 3))
            except Exception as exc:    # a side whose call cannot be captured
                errors[k] = repr(exc)
    out = {}
    for k, t in times.items():
        if k in errors:
            out[k] = {"error": errors[k]}
            continue
        f_ms = statistics.median(t["flagship"])
        b_ms = statistics.median(t["big_leaf"])
        out[k] = {"flagship_ms": f_ms,
                  "flagship_tb_s": flagship_bytes / f_ms / 1e9,
                  "big_leaf_ms": b_ms, "big_leaf_tb_s": big_bytes / b_ms / 1e9,
                  "runs": t}
    out["empty_kernel_graph_ms"] = _graph_ms(
        torch, [lambda: torch.cuda._sleep(0)] * updates, 10)
    src = torch.empty(2 ** 28, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = _graph_ms(torch, [lambda: dst.copy_(src)] * 4, 3)
    out["copy_ms"] = copy_ms
    out["copy_tb_s"] = 2 * src.numel() * 4 / copy_ms / 1e9
    out["bytes"] = {"flagship": flagship_bytes, "big_leaf": big_bytes,
                    "copy": 2 * src.numel() * 4}
    return out


def corner_cases(torch):
    """Leaves of 0, 1, 3, 7, 8, 9, 1,023 and 1,025 elements and views at
    element offset 1, per optimizer; the Q-network's leaves under a bool
    gate off and on."""
    from sharetrade_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(3)

    def randn(n, dtype=torch.float32):
        return torch.randn(n, generator=gen, device="cuda").to(dtype)

    _, bias = fu.adam_bias(torch.tensor(2, dtype=torch.int32, device="cuda"))
    for optimizer, dtype, emit in (("adagrad", torch.bfloat16, True),
                                   ("adam", torch.float32, True),
                                   ("sgd", torch.float32, False)):
        sizes = [0, 1, 3, 7, 8, 9, 1023, 1025]
        params = [randn(n) for n in sizes] + [randn(1026)[1:], randn(9)[1:]]
        grads = [randn(n, dtype) for n in sizes] + [
            randn(1026, dtype)[1:], randn(9, dtype)[1:]]
        n_state = {"adagrad": 1, "adam": 2, "sgd": 0}[optimizer]
        state = [[randn(p.numel()).abs() + 0.1 for p in params]
                 for _ in range(n_state)]
        yield (f"odd_sizes_{optimizer}", optimizer, params, grads, state,
               bias if optimizer == "adam" else None, emit, None)
    shapes = [(203, 200), (200,), (200, 3), (3,)]
    params = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    grads = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    state = [[torch.full(s, 0.1, device="cuda") for s in shapes]]
    for flag in (False, True):
        yield (f"gate_{'on' if flag else 'off'}", "adagrad", params, grads,
               state, None, True, torch.tensor(flag, device="cuda"))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True,
                        help="a checkout of the parent commit")
    parser.add_argument("--rounds", type=int, default=4,
                        help="timing turns per side and case")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_update_ab: no CUDA device visible", file=sys.stderr)
        return 1
    from sharetrade_tpu_torch.ops import fused_update as fu

    print(chip_smoke._nvidia_smi(), flush=True)
    with tempfile.TemporaryDirectory(prefix="update-ab-") as build_dir:
        old = parent_wrapper(os.path.abspath(args.parent), build_dir)
        sides = {"parent": old, "change": fu}
        failures = []
        for name, optimizer, params, grads, state, bias, emit, gate in \
                corner_cases(torch):
            outs = {k: _run(torch, m, optimizer, params, grads, state, bias,
                            emit, gate) for k, m in sides.items()}
            equal = _bit_equal(torch, outs["parent"], outs["change"])
            _print({"case": name, "bit_equal": equal})
            if not equal:
                failures.append(name)
        summary = {}
        for case in chip_smoke.UPDATE_CASES:
            params, grads, state, bias = chip_smoke.update_inputs(torch,
                                                                  **case)
            optimizer, emit = case["optimizer"], case.get("emit", False)
            here = sides
            outs = {k: _run(torch, m, optimizer, params, grads, state, bias,
                            emit) for k, m in here.items()}
            equal = all(_bit_equal(torch, outs["parent"], out)
                        for out in outs.values())
            if not equal:
                failures.append(case["name"])
            times: dict = {k: {"kernel_ms": [], "kernel_clean_l2_ms": [],
                               "call_ms": [], "host_us": []}
                           for k in here}
            for r in range(args.rounds):
                order = list(here) if r % 2 == 0 else list(here)[::-1]
                for k in order:
                    p, s, c = _run(torch, here[k], optimizer, params, grads,
                                   state, bias, emit)

                    def call(m=here[k], p=p, s=s, c=c):
                        m.fused_update(optimizer, 0.01, p, grads, s,
                                       bias=bias, compute=c)

                    times[k]["kernel_ms"].append(
                        chip_smoke._time_ms(torch, call))
                    times[k]["kernel_clean_l2_ms"].append(
                        chip_smoke._time_ms(torch, call, clean_l2=True))
                    times[k]["call_ms"].append(
                        chip_smoke._time_ms(torch, call, host_ahead=False))
                    times[k]["host_us"].append(
                        chip_smoke._host_us(torch, call))
            medians = {k: {m: statistics.median(v) for m, v in t.items()}
                       for k, t in times.items()}
            # The event-timed floor: a kernel that does nothing.
            medians["empty_kernel_ms"] = chip_smoke._time_ms(
                torch, lambda: torch.cuda._sleep(0))
            medians["change"]["python_us"] = python_us(torch, fu, optimizer,
                                                       params, grads, state,
                                                       bias, emit)
            summary[case["name"]] = medians
            _print({"case": case["name"], "bit_equal": equal,
                    "parameters": sum(p.numel() for p in params),
                    "leaves": len(params), "median": medians, "runs": times})
        stream = stream_rates(torch, sides)
    _print({"summary": summary, "bit_equal_everywhere": not failures,
            "failures": failures})
    _print({"stream": stream})
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
