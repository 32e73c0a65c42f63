"""``cli train`` of this checkout against a parent checkout, on one card.

    python3 tools/torch_train_ab.py --parent DIR [--workload flagship]
                                    [--pairs 3] [--repeats 3]

Part 1, end to end: ``python -m sharetrade_tpu_torch.cli train`` from the
checkout at ``--parent`` and from this one, each run in a fresh temporary
working directory (its checkpoints land there) with the tree on
``PYTHONPATH``. ``--workload flagship``: the flagship config
(``chip_smoke.FLAGSHIP_TRAIN``) with the 2,249-price series, one 2-chunk
episode; ``--workload reference``: the JAX package's defaults, no
``--set`` at all (the Q-network's one 5,845-step Q-learning episode).
Each tree first runs once to build its kernels (reported, not counted);
then ``--pairs`` pairs in the order parent, this, this, parent, parent,
this, ... One JSON line per run (``elapsed_s``, ``agent_steps_per_sec``,
``avg_portfolio``, ``std_portfolio``), then the medians of each tree and
whether every run of both trees ended on the same portfolio digits.

Part 2, the split, in this process and this checkout: the same training
through the ``Orchestrator``, ``--repeats`` times each with checkpoints as
the default config writes them (a baseline ``save_async`` before chunk 0,
then the synchronous final save) and with
``runtime.checkpoint_every_updates=0`` (no baseline; the final save
stays), alternating, after one warm-up run. Each run gives the baseline
``save_async`` call's host time and its ``save_stats``, each chunk's step
time (wall clock from one chunk's row to the next: the writer of the
baseline runs beside chunk 0),
the wait for that writer before the final save, the final save's time, and
the run's wall time. Then the medians of each setting. Flagship only;
``--repeats 0`` skips it.

Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import FLAGSHIP_TRAIN  # noqa: E402

CONFIG = FLAGSHIP_TRAIN + ["data.synthetic_length=2249"]
#: ``--set`` items of each workload.
WORKLOADS = {"flagship": CONFIG, "reference": []}


def _print(obj) -> None:
    print(json.dumps(obj), flush=True)


def cli_train(tree: str, items: list[str]) -> dict:
    """One ``cli train`` run of ``tree`` with ``--set`` ``items``, from a
    fresh working directory: its summary line."""
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "train"]
    for item in items:
        cmd += ["--set", item]
    env = dict(os.environ, PYTHONPATH=tree)
    with tempfile.TemporaryDirectory(prefix="train-ab-") as cwd:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900, cwd=cwd, env=env)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"cli train in {tree} exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    return json.loads(lines[-1])


def part1(parent: str, pairs: int, items: list[str]) -> dict:
    trees = {"parent": parent, "change": ROOT}
    keys = ("elapsed_s", "agent_steps_per_sec", "avg_portfolio",
            "std_portfolio")
    digits = set()
    for name, tree in trees.items():
        out = cli_train(tree, items)
        digits.add((out["avg_portfolio"], out["std_portfolio"]))
        _print({"part": 1, "warmup": name, **out})
    order = []
    for i in range(pairs):
        order += (["parent", "change"] if i % 2 == 0
                  else ["change", "parent"])
    runs: dict[str, list] = {"parent": [], "change": []}
    for name in order:
        out = cli_train(trees[name], items)
        runs[name].append(out)
        digits.add((out["avg_portfolio"], out["std_portfolio"]))
        _print({"part": 1, "tree": name, **{k: out[k] for k in keys}})
    summary = {name: {key: statistics.median(r[key] for r in rows)
                      for key in ("elapsed_s", "agent_steps_per_sec")}
               for name, rows in runs.items()}
    summary["order"] = order
    summary["portfolio_digits"] = sorted(digits)
    summary["bit_equal"] = len(digits) == 1
    return summary


def _timed(record: list, fn):
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            record.append(time.perf_counter() - t0)
    return wrapped


def one_run(torch, prices, extra: list[str]) -> dict:
    """One in-process training run with the saves' calls timed."""
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.runtime import Orchestrator

    with tempfile.TemporaryDirectory(prefix="train-ab-") as ckpts:
        cfg = FrameworkConfig().apply_overrides(
            CONFIG + [f"runtime.checkpoint_dir={ckpts}"] + extra)
        marks: list = []
        orch = Orchestrator(cfg, device="cuda",
                            fault_hook=lambda i, row: marks.append(
                                time.perf_counter()))
        manager = orch.checkpoints
        calls: dict[str, list] = {"save_async": [], "wait_pending": [],
                                  "save": []}
        for name, record in calls.items():
            setattr(manager, name, _timed(record, getattr(manager, name)))
        orch.send_training_data(prices)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orch.start_training(background=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        orch.stop()
        # Hook to hook: a fault hook reads every chunk's row back.
        chunks = [b - a for a, b in zip([t0] + marks, marks)]
        return {"wall_s": wall, "chunk_s": chunks,
                "save_async_s": calls["save_async"],
                "wait_pending_before_final_s": calls["wait_pending"][:1],
                "final_save_s": calls["save"],
                "save_stats": list(manager.save_stats)}


def part2(repeats: int) -> dict:
    import torch
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.data.service import PriceDataService

    cfg = FrameworkConfig().apply_overrides(CONFIG)
    prices = PriceDataService(config=cfg.data).request("MSFT").series.prices
    settings = {"baseline_save": [],
                "no_baseline_save": ["runtime.checkpoint_every_updates=0"]}
    _print({"part": 2, "warmup": one_run(torch, prices, [])})
    runs: dict[str, list] = {name: [] for name in settings}
    for _ in range(repeats):
        for name, extra in settings.items():
            out = one_run(torch, prices, extra)
            runs[name].append(out)
            _print({"part": 2, "setting": name, **out})

    def med(rows, fn):
        values = [fn(r) for r in rows]
        values = [v for v in values if v is not None]
        return statistics.median(values) if values else None

    summary = {}
    for name, rows in runs.items():
        summary[name] = {
            "wall_s": med(rows, lambda r: r["wall_s"]),
            "chunk0_s": med(rows, lambda r: r["chunk_s"][0]),
            "chunk1_s": med(rows, lambda r: r["chunk_s"][1]),
            "baseline_save_async_s": med(
                rows, lambda r: r["save_async_s"][0]
                if r["save_async_s"] else None),
            "baseline_writer_ms": med(
                rows, lambda r: r["save_stats"][0].get("writer_ms")
                if r["save_async_s"] else None),
            "wait_pending_before_final_s": med(
                rows, lambda r: r["wait_pending_before_final_s"][0]
                if r["wait_pending_before_final_s"] else None),
            "final_save_s": med(rows, lambda r: r["final_save_s"][0]),
        }
    return summary


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", required=True,
                        help="a checkout of the parent commit")
    parser.add_argument("--workload", choices=sorted(WORKLOADS),
                        default="flagship")
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "workload": args.workload,
              "part1": part1(os.path.abspath(args.parent), args.pairs,
                             WORKLOADS[args.workload])}
    if args.workload == "flagship" and args.repeats > 0:
        result["part2"] = part2(args.repeats)
    _print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
