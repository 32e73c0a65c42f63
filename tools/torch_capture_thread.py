"""Where the chunk program is captured: the main thread against a second
thread, on one card.

    python3 tools/torch_capture_thread.py [--workload reference|flagship]
                                          [--pairs 3]

Each run is a fresh process (``--one``), so neither side inherits a warm
allocator or a warmed-up thread: it builds the workload's agent
(``reference``: the JAX package's defaults, the Q-network's Q-learning;
``flagship``: ``chip_smoke.FLAGSHIP_TRAIN``), then on the main thread or on
one ``threading.Thread`` (the main thread joined, as ``cli train`` once ran
its loop) dispatches two chunks through a ``ChunkProgram``: the eager
warm-up chunk, then the capture and the first replay. One JSON line per
run (``warm_up_s``, ``capture_s`` as the program reports it,
``second_dispatch_s``), the runs in the order main, thread, thread, main,
..., then the medians of each side. ``cli train`` runs its loop on the main
thread because of what this measures.

Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import FLAGSHIP_TRAIN  # noqa: E402

WORKLOADS = {"reference": [], "flagship": FLAGSHIP_TRAIN}


def one(workload: str, where: str) -> dict:
    """Two chunks of ``workload`` through a chunk program, on ``where``
    ("main" or "thread"); the seconds of each part."""
    import torch
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.agents.base import ChunkProgram
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.env.trading import make_trading_env

    out: dict = {"workload": workload, "where": where}

    def run():
        cfg = FrameworkConfig().apply_overrides(WORKLOADS[workload])
        prices = PriceDataService(config=cfg.data).request(
            "MSFT").series.prices
        env = make_trading_env(prices, window=cfg.env.window, device="cuda")
        agent = build_agent(cfg, env, device="cuda")
        program = ChunkProgram(agent)
        ts = agent.init(cfg.seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _ = program(ts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ts, _ = program(ts)
        torch.cuda.synchronize()
        out.update(warm_up_s=t1 - t0, capture_s=program.capture_seconds,
                   second_dispatch_s=time.perf_counter() - t1,
                   graph_nodes=program.nodes)

    if where == "main":
        run()
    else:
        worker = threading.Thread(target=run)
        worker.start()
        worker.join()
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", choices=sorted(WORKLOADS),
                        default="reference")
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--one", choices=("main", "thread"),
                        help="run one side in this process")
    args = parser.parse_args()
    if args.one:
        print(json.dumps(one(args.workload, args.one)), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    order = []
    for i in range(args.pairs):
        order += ["main", "thread"] if i % 2 == 0 else ["thread", "main"]
    # One unrecorded run first: it builds the kernels for all the rest.
    runs: dict[str, list] = {"main": [], "thread": []}
    for k, where in enumerate(["main"] + order):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--workload",
             args.workload, "--one", where], capture_output=True,
            text=True, timeout=900, cwd=ROOT)
        if proc.returncode != 0:
            raise RuntimeError(f"{where} run exited {proc.returncode}: "
                               f"{proc.stderr[-2000:]}")
        row = json.loads(proc.stdout.strip().splitlines()[-1])
        if k:
            runs[where].append(row)
        print(json.dumps({"build_run": k == 0, **row}), flush=True)
    summary = {where: {key: statistics.median(r[key] for r in rows)
                       for key in ("warm_up_s", "capture_s",
                                   "second_dispatch_s")}
               for where, rows in runs.items()}
    print(json.dumps({"card": card, "workload": args.workload,
                      "order": order, "medians": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
