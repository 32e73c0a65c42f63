"""What DQN's transition journal costs a chunk, on one card.

    python3 tools/torch_journal_cost.py [--repeats 2] [--chunks 10]

One process runs the reference DQN episode (the JAX package's defaults
with ``learner.algo=dqn``: the 203 -> 200 -> 3 Q-network, 10 agents,
200-step chunks, the 5,845-step series) through the orchestrator at its
defaults (graph, async pipeline, sampled readback), four ways, in turns
(the order below, then the reverse, ``--repeats`` times in all), after one
plain run that warms the process up and is not kept:

- ``plain``: no journal (metrics read back every 10th chunk);
- ``journaled``: ``learner.journal_replay=true`` at the default group
  commit (``data.journal_fsync_every_records=64``,
  ``data.journal_fsync_interval_s=0.5``: one write and one fsync a
  commit);
- ``journaled_no_fsync``: the same with both watermarks off
  (``journal_fsync_every_records=1``, ``journal_fsync_interval_s=0``: a
  write and flush per chunk, never an fsync), to show the fsync's share.
  Not a setting to run with: an append that returned is then not durable;
- ``journaled_depth8``: journaled with ``runtime.pipeline_depth=8``, to
  show the share of the dispatcher's waits on the 2-deep queue.

Then the chunk program alone, without the orchestrator: a plain and a
journaled DQN agent, each warmed and captured, then ``--chunks`` replays
each in turns, each timed on the host from the call to a synchronize: the
replay (``program(ts)``) and, for the journaled one, the replay with its
pinned readback of metrics and transitions waited for.

One JSON line per run: wall seconds, the timer's mean chunk ms (capture and
the eager first chunk included), the dispatcher's pipeline stalls, the
cadence checkpoints written (a run that reads every chunk back crosses
each ``checkpoint_every_updates`` mark on time; a sampled one only at its
samples), and on
the consumer thread the ms of each boundary's host work (readback wait,
journal append, rows) and of each journal append (median, p90, max); then
the medians of each way and the card's name and power limit.

Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WAYS = {
    "plain": ["learner.algo=dqn"],
    "journaled": ["learner.algo=dqn", "learner.journal_replay=true"],
    "journaled_no_fsync": ["learner.algo=dqn", "learner.journal_replay=true",
                           "data.journal_fsync_every_records=1",
                           "data.journal_fsync_interval_s=0"],
    "journaled_depth8": ["learner.algo=dqn", "learner.journal_replay=true",
                         "runtime.pipeline_depth=8"],
}


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _stats(ms: list[float]) -> dict:
    if not ms:
        return {}
    ordered = sorted(ms)
    return {"median": statistics.median(ordered),
            "p90": ordered[int(0.9 * (len(ordered) - 1))],
            "max": ordered[-1], "n": len(ordered)}


def one_run(torch, prices, way: str, root: str) -> dict:
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.runtime import Orchestrator
    from sharetrade_tpu_torch.utils.logging import EventLog

    where = tempfile.mkdtemp(prefix=f"{way}-", dir=root)
    cfg = FrameworkConfig().apply_overrides(
        WAYS[way] + [f"runtime.checkpoint_dir={where}/ckpt",
                     f"data.journal_dir={where}/journal"])
    log_path = os.path.join(where, "events.jsonl")
    events = EventLog(log_path)
    orch = Orchestrator(cfg, device="cuda", event_log=events)
    host_ms: list[float] = []
    append_ms: list[float] = []
    host_process, append = orch._host_process, orch._journal_transitions

    def timed_host(boundary):
        t = time.perf_counter()
        try:
            return host_process(boundary)
        finally:
            host_ms.append((time.perf_counter() - t) * 1e3)

    def timed_append(transitions, env_steps):
        t = time.perf_counter()
        append(transitions, env_steps)
        append_ms.append((time.perf_counter() - t) * 1e3)

    orch._host_process, orch._journal_transitions = timed_host, timed_append
    orch.send_training_data(prices)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    orch.start_training(background=False)
    wall = time.perf_counter() - t0
    orch.stop()
    events.close()
    done = [json.loads(ln) for ln in open(log_path)
            if '"training_completed"' in ln]
    out = {"way": way, "completed": bool(done), "wall_s": wall,
           "chunks": orch.chunks,
           "mean_chunk_ms": (done[0]["mean_chunk_seconds"] * 1e3
                             if done else None),
           "capture_s": orch._program.capture_seconds,
           "pipeline_stalls": orch.metrics.counters().get(
               "pipeline_stalls_total", 0.0),
           "checkpoints": orch.metrics.counters().get(
               "checkpoints_total", 0.0),
           "boundaries": orch.pipeline_stats.get("boundaries"),
           "host_process_ms": _stats(host_ms),
           "append_ms": _stats(append_ms)}
    shutil.rmtree(where, ignore_errors=True)
    return out


def replays(torch, prices, chunks: int) -> dict:
    """Host ms from the call to a synchronize of each replay, plain and
    journaled agents in turns (see the module docstring)."""
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.agents.base import ChunkProgram
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import make_trading_env

    progs = {}
    for way in ("plain", "journaled"):
        cfg = FrameworkConfig().apply_overrides(WAYS[way])
        env = make_trading_env(prices, window=cfg.env.window, device="cuda")
        agent = build_agent(cfg, env, device="cuda")
        program = ChunkProgram(agent)
        ts = agent.init(cfg.seed)
        for _ in range(3):                 # warm-up, capture, one replay
            ts, _ = program(ts)
        progs[way] = [program, ts]
    torch.cuda.synchronize()
    ms: dict[str, list[float]] = {"plain": [], "journaled": [],
                                  "journaled_with_readback": []}
    for _ in range(chunks):
        for name in ms:
            entry = progs["plain" if name == "plain" else "journaled"]
            t = time.perf_counter()
            entry[1], stacked = entry[0](entry[1])
            if name == "journaled_with_readback":
                readback = entry[0].readback(stacked)
                readback.rows()
                readback.transitions()
            torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t) * 1e3)
    return {name: _stats(v) for name, v in ms.items()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repeats", type=int, default=2)
    parser.add_argument("--chunks", type=int, default=10)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_journal_cost: needs a CUDA device", file=sys.stderr)
        return 1
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.data.service import PriceDataService

    card = _card()
    print(card, flush=True)
    root = tempfile.mkdtemp(prefix="journal-cost-")
    try:
        data = FrameworkConfig().data
        data.journal_dir = os.path.join(root, "prices")
        service = PriceDataService(config=data)
        prices = service.request("MSFT").series.prices
        service.close()
        one_run(torch, prices, "plain", root)          # warm-up, not kept
        order = list(WAYS)
        runs: dict[str, list] = {way: [] for way in WAYS}
        for r in range(args.repeats):
            for way in (order if r % 2 == 0 else order[::-1]):
                out = one_run(torch, prices, way, root)
                runs[way].append(out)
                print(json.dumps(out), flush=True)
        summary = {way: {
            "wall_s": statistics.median(r["wall_s"] for r in rows),
            "mean_chunk_ms": statistics.median(r["mean_chunk_ms"]
                                               for r in rows),
            "pipeline_stalls": statistics.median(r["pipeline_stalls"]
                                                 for r in rows),
            "append_ms_median": (statistics.median(
                r["append_ms"]["median"] for r in rows)
                if rows[0]["append_ms"] else None)}
            for way, rows in runs.items()}
        ok = all(r["completed"] for rows in runs.values() for r in rows)
        replay_ms = replays(torch, prices, args.chunks)
        print(json.dumps({"card": card, "replay_ms": replay_ms}), flush=True)
        print(json.dumps({"card": card, "summary": summary, "ok": ok}),
              flush=True)
        return 0 if ok else 1
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
