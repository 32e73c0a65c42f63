#!/usr/bin/env python
"""Offline autotune of the PyTorch/CUDA port: seeded successive-halving
sweeps over the knob registry, writing a per-host ``tuned_profile.json``.

The port's counterpart of ``tools/autotune.py``, built from the port alone
(``sharetrade_tpu_torch``; it imports nothing of the JAX package and no
other tool). Three workload specs, each sweeping the registered knobs
(``sharetrade_tpu_torch/tuning.py`` ``KNOBS``) of one tier with a short
measured window per trial and an early-stopping search:

- **train**: ``runtime.megachunk_factor`` x ``runtime.pipeline_depth`` on
  the reference Q-learning workload at a host-bound size (a q_mlp of 8
  hidden units, 10 agents, 32 chunks of 10 steps an episode) through the
  port's ``Orchestrator``; objective: agent-steps/s.
- **serve**: ``serve.max_batch`` x ``serve.batch_timeout_ms`` x
  ``serve.max_queue`` on the q_mlp serving workload (the reference
  Q-network's head, 200 hidden units, window 16) through the port's
  ``ServeEngine`` and ``run_closed_loop``; objective: closed-loop QPS at
  twice the batch in flight, the p99 at that load kept per trial.

- **distrib**: ``distrib.ingest_every_updates`` x ``distrib.ingest_max_rows``
  against a feeder thread appending transition rows to an actor journal at
  a fixed rate while a DQN learner (``distrib.num_actors=1``, no pool, the
  adaptive cadence off) trains fixed episodes through the port's
  ``Orchestrator`` and ingests at the arm's cadence; objective: the
  geometric mean of updates/s and ingested rows/s, the two the cadence
  trades against each other.

Search: **successive halving**: every arm runs at the smallest window, the
top ``1/eta`` survive to a doubled window, until one arm stands. Per-arm
state (an orchestrator with its captured chunk program, a warmed engine) is
cached across rungs, so an arm pays its build once under either search
mode. ``--exhaustive`` also measures every arm at twice the final window,
best of two (the hand-sweep baseline).

Output: an atomic, schema-versioned profile (host fingerprint: cores,
backend, device count) that ``cli train`` / ``cli serve`` load through
``--set tuning.profile=PATH``: explicit config wins over the profile, the
profile over the defaults. Each package's ``load_profile`` reads the
other's file.

Runs on the CUDA device unless ``--device cpu`` is given; without a GPU
and without ``--device cpu`` it exits 2 with a message.

Usage:
    python3 tools/torch_autotune.py                    # train + serve
    python3 tools/torch_autotune.py --quick --spec serve --out p.json
    python3 tools/torch_autotune.py --spec serve --exhaustive --seed 7
    python3 tools/torch_autotune.py --quick --spec distrib --device cpu
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sharetrade_tpu_torch import tuning  # noqa: E402
from sharetrade_tpu_torch.config import FrameworkConfig  # noqa: E402
from sharetrade_tpu_torch.utils.logging import get_logger  # noqa: E402

log = get_logger("autotune")


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------

def train_grid(quick: bool) -> list[dict]:
    ks = (1, 8) if quick else (1, 4, 8, 16)
    depths = (2,) if quick else (1, 2, 4)
    return [{"runtime.megachunk_factor": k, "runtime.pipeline_depth": d}
            for k in ks for d in depths]


def serve_grid(quick: bool) -> list[dict]:
    if quick:
        batches, timeouts, queues = (8, 32), (0.5, 2.0), (256,)
    else:
        batches, timeouts, queues = ((8, 16, 32, 64), (0.5, 2.0, 8.0),
                                     (128, 512))
    return [{"serve.max_batch": b, "serve.batch_timeout_ms": t,
             "serve.max_queue": q}
            for b in batches for t in timeouts for q in queues]


def distrib_grid(quick: bool) -> list[dict]:
    everies = (4, 16) if quick else (2, 8, 32)
    rows = (4096,) if quick else (1024, 8192)
    return [{"distrib.ingest_every_updates": e,
             "distrib.ingest_max_rows": r}
            for e in everies for r in rows]


# ---------------------------------------------------------------------------
# measurers (one class per spec; per-arm state cached across rungs)
# ---------------------------------------------------------------------------

class TrainMeasurer:
    """The reference Q-learning workload through the port's orchestrator:
    one orchestrator per arm (cached: its first episode, which builds the
    chunk program and captures it, runs once at construction); a window of
    weight ``w`` runs ``w`` more episodes and times them."""

    CHUNKS = 32                 # per episode; divisible by every K above
    CHUNK_STEPS = 10
    WORKERS = 10

    def __init__(self, *, seed: int, workdir: str, device: str):
        self.seed = seed
        self.workdir = workdir
        self.device = device
        self._orchs: dict[tuple, object] = {}

    def _orch(self, arm: dict):
        from sharetrade_tpu_torch.data.synthetic import synthetic_price_series
        from sharetrade_tpu_torch.runtime.orchestrator import Orchestrator
        key = tuple(sorted(arm.items()))
        orch = self._orchs.get(key)
        if orch is not None:
            return orch
        cfg = FrameworkConfig()
        cfg.seed = self.seed
        cfg.learner.algo = "qlearn"
        cfg.parallel.num_workers = self.WORKERS
        cfg.env.window = 8
        cfg.model.hidden_dim = 8            # host-bound on purpose
        cfg.runtime.chunk_steps = self.CHUNK_STEPS
        cfg.runtime.checkpoint_every_updates = 0
        cfg.runtime.keep_best_eval = False
        cfg.runtime.checkpoint_dir = os.path.join(
            self.workdir, f"ck-{len(self._orchs)}")
        for path, value in arm.items():
            tuning.set_knob(cfg, path, value)
        series = synthetic_price_series(
            length=cfg.env.window + self.CHUNKS * self.CHUNK_STEPS + 8,
            seed=self.seed)
        orch = Orchestrator(cfg, device=self.device)
        orch.send_training_data(series.prices)
        orch.start_training(background=False)   # build, capture, warm
        self._orchs[key] = orch
        return orch

    def measure(self, arm: dict, window: float) -> dict:
        orch = self._orch(arm)
        episodes = max(1, int(round(window)))
        t0 = time.perf_counter()
        for _ in range(episodes):
            orch.start_training(background=False)   # re-arms, same graph
        elapsed = time.perf_counter() - t0
        steps = episodes * self.CHUNKS * self.CHUNK_STEPS * self.WORKERS
        return {"objective": steps / elapsed,
                "agent_steps_per_sec": round(steps / elapsed, 2),
                "elapsed_s": round(elapsed, 4)}

    def close(self) -> None:
        for orch in self._orchs.values():
            orch.stop()
        self._orchs.clear()


class ServeMeasurer:
    """Closed-loop QPS per serve-knob arm on the q_mlp serving workload;
    engines cached per arm across rungs (one build and warm-up each). The
    p99 at that load rides along per trial."""

    def __init__(self, *, seed: int, device: str):
        import torch

        from sharetrade_tpu_torch.config import ModelConfig
        from sharetrade_tpu_torch.data.synthetic import synthetic_price_series
        from sharetrade_tpu_torch.models import build_model
        self.seed = seed
        self.window = 16
        self.prices = synthetic_price_series(length=2048, seed=seed).prices
        self.model = build_model(ModelConfig(kind="mlp", hidden_dim=200),
                                 self.window + 2, head="q", device=device)
        self.params = self.model.init(torch.Generator().manual_seed(seed))
        self._engines: dict[tuple, object] = {}
        self._serial = 0

    def _engine(self, arm: dict):
        from sharetrade_tpu_torch.config import ServeConfig
        from sharetrade_tpu_torch.serve import ServeEngine
        key = tuple(sorted(arm.items()))
        engine = self._engines.get(key)
        if engine is not None:
            return engine
        mb = int(arm["serve.max_batch"])
        cfg = ServeConfig(
            max_batch=mb, slots=4 * mb,
            batch_timeout_ms=float(arm["serve.batch_timeout_ms"]),
            max_queue=int(arm["serve.max_queue"]),
            swap_poll_s=0.0, stats_interval_s=0.5)
        engine = ServeEngine(self.model, cfg, self.params)
        engine.warmup()
        self._engines[key] = engine
        return engine

    def measure(self, arm: dict, window: float) -> dict:
        from sharetrade_tpu_torch.serve.driver import (
            make_sessions, run_closed_loop)
        engine = self._engine(arm)
        self._serial += 1
        mb = int(arm["serve.max_batch"])
        sessions = make_sessions(self.prices, self.window, 8 * mb,
                                 seed=self.seed,
                                 prefix=f"at{self._serial}-")
        run = run_closed_loop(engine, sessions, concurrency=2 * mb,
                              duration_s=max(0.2, float(window)))
        return {"objective": run["qps"],
                "qps": round(run["qps"], 1),
                "p99_ms": round(run["p99_ms"], 3),
                "elapsed_s": round(run["elapsed_s"], 4)}

    def close(self) -> None:
        for engine in self._engines.values():
            engine.stop(drain=False)
        self._engines.clear()


class DistribMeasurer:
    """The learner's ingest cadence against a live feed: a feeder thread
    appends ``FEED_BATCH``-row records to a synthetic actor journal
    ``FEED_HZ`` times a second while a DQN learner trains fixed episodes
    and ingests at the arm's cadence. The adaptive cadence is off, so each
    arm measures its own. Per-arm orchestrators are cached across rungs;
    the feed's env-step stamps continue across windows, so the learner's
    cursor keeps advancing over one growing journal. Updates/s counts one
    DQN update per env step (``tools/autotune.py`` counts one per chunk, a
    constant factor that ranks the arms alike)."""

    CHUNKS = 24
    CHUNK_STEPS = 10
    FEED_HZ = 40                # records per second
    FEED_BATCH = 64             # rows per record

    def __init__(self, *, seed: int, workdir: str, device: str):
        self.seed = seed
        self.workdir = workdir
        self.device = device
        #: arm key -> (orchestrator, journal path, obs_dim, rng, [stamp]).
        self._arms: dict[tuple, tuple] = {}

    def _arm_state(self, arm: dict):
        import numpy as np

        from sharetrade_tpu_torch.data.synthetic import synthetic_price_series
        from sharetrade_tpu_torch.distrib.actor import TRANSITIONS_FILE
        from sharetrade_tpu_torch.runtime.orchestrator import Orchestrator
        key = tuple(sorted(arm.items()))
        state = self._arms.get(key)
        if state is not None:
            return state
        root = os.path.join(self.workdir, f"arm-{len(self._arms)}")
        actor_dir = os.path.join(root, "actors")
        os.makedirs(os.path.join(actor_dir, "a0"), exist_ok=True)
        cfg = FrameworkConfig()
        cfg.seed = self.seed
        cfg.learner.algo = "dqn"
        cfg.parallel.num_workers = 10
        cfg.env.window = 8
        cfg.model.hidden_dim = 8
        cfg.learner.replay_capacity = 16384
        cfg.runtime.chunk_steps = self.CHUNK_STEPS
        cfg.runtime.checkpoint_every_updates = 0
        cfg.runtime.keep_best_eval = False
        cfg.runtime.checkpoint_dir = os.path.join(root, "ck")
        cfg.data.journal_dir = os.path.join(root, "journal")
        cfg.distrib.num_actors = 1          # enables ingest; no pool here
        cfg.distrib.actor_dir = actor_dir
        cfg.tuning.adaptive_ingest = False  # measure the arm's cadence
        for path, value in arm.items():
            tuning.set_knob(cfg, path, value)
        series = synthetic_price_series(
            length=cfg.env.window + self.CHUNKS * self.CHUNK_STEPS + 8,
            seed=self.seed)
        orch = Orchestrator(cfg, device=self.device)
        orch.send_training_data(series.prices)
        orch.start_training(background=False)       # build, capture, warm
        state = (orch, os.path.join(actor_dir, "a0", TRANSITIONS_FILE),
                 cfg.env.window + 2, np.random.default_rng(self.seed), [0])
        self._arms[key] = state
        return state

    def measure(self, arm: dict, window: float) -> dict:
        import numpy as np

        from sharetrade_tpu_torch.data.journal import Journal
        from sharetrade_tpu_torch.data.transitions import append_transitions

        orch, journal_path, obs_dim, rng, stamp = self._arm_state(arm)
        episodes = max(1, int(round(window)))
        stop = threading.Event()
        fed = [0]

        def feeder():
            # The arm's journal reopened in this process (the writer lock
            # is per process); stamps continue monotone across windows.
            journal = Journal(journal_path, segment_records=256)
            try:
                while not stop.is_set():
                    stamp[0] += self.FEED_BATCH
                    obs = rng.standard_normal(
                        (self.FEED_BATCH, obs_dim)).astype(np.float32)
                    append_transitions(
                        journal, obs,
                        rng.integers(0, 3, self.FEED_BATCH, dtype=np.int32),
                        rng.standard_normal(self.FEED_BATCH).astype(
                            np.float32),
                        obs, env_steps=stamp[0])
                    journal.flush()
                    fed[0] += self.FEED_BATCH
                    stop.wait(1.0 / self.FEED_HZ)
            finally:
                journal.close()

        thread = threading.Thread(target=feeder, daemon=True)
        rows0 = orch.metrics.counters().get("distrib_rows_ingested_total",
                                            0.0)
        thread.start()
        try:
            t0 = time.perf_counter()
            for _ in range(episodes):
                orch.start_training(background=False)
            elapsed = time.perf_counter() - t0
            rows = orch.metrics.counters().get(
                "distrib_rows_ingested_total", 0.0) - rows0
        finally:
            stop.set()
            thread.join(5.0)
        updates_ps = episodes * self.CHUNKS * self.CHUNK_STEPS / elapsed
        rows_ps = rows / elapsed
        return {
            "objective": math.sqrt(max(updates_ps, 1e-9)
                                   * max(rows_ps, 1e-9)),
            "updates_per_sec": round(updates_ps, 2),
            "rows_ingested_per_sec": round(rows_ps, 1),
            "rows_fed": fed[0],
            "elapsed_s": round(elapsed, 4),
        }

    def close(self) -> None:
        for orch, *_ in self._arms.values():
            orch.stop()
        self._arms.clear()


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def successive_halving(arms: list[dict], measure, *, rung0_window: float,
                       eta: int = 4, max_rungs: int = 4,
                       log_fn=None) -> dict:
    """Run the halving ladder; returns ``{"best", "trials", "rungs",
    "top_window", "wall_s", "measure_s"}``. Ties break by grid order;
    ``measure_s`` sums the trials' measured windows only (every arm builds
    once under any strategy)."""
    say = log_fn or (lambda msg: log.info("%s", msg))
    t_start = time.perf_counter()
    survivors = list(arms)
    window = rung0_window
    trials: list[dict] = []
    rungs = 0
    measure_s = 0.0
    while True:
        rung_results = []
        for arm in survivors:
            res = measure(arm, window)
            trials.append({"arm": arm, "window": window, **res})
            measure_s += res.get("elapsed_s", 0.0)
            rung_results.append((res["objective"], arm))
            say(f"rung {rungs} window={window:g}: {arm} -> "
                f"objective {res['objective']:.1f}")
        rungs += 1
        if len(survivors) == 1 or rungs >= max_rungs:
            best = max(rung_results, key=lambda t: t[0])[1]
            break
        keep = max(1, math.ceil(len(survivors) / eta))
        ranked = sorted(rung_results, key=lambda t: -t[0])
        survivors = [arm for _, arm in ranked[:keep]]
        window *= 2
    return {"best": best, "trials": trials, "rungs": rungs,
            "top_window": window,
            "wall_s": time.perf_counter() - t_start,
            "measure_s": measure_s}


def run_spec(spec: str, *, quick: bool, seed: int, workdir: str,
             exhaustive: bool, device: str, log_fn=None) -> dict:
    say = log_fn or (lambda msg: log.info("%s", msg))
    if spec == "train":
        grid = train_grid(quick)
        measurer = TrainMeasurer(seed=seed, workdir=workdir, device=device)
        rung0 = 2.0 if quick else 8.0       # episodes
    elif spec == "serve":
        grid = serve_grid(quick)
        measurer = ServeMeasurer(seed=seed, device=device)
        rung0 = 0.3 if quick else 0.5       # seconds
    elif spec == "distrib":
        grid = distrib_grid(quick)
        measurer = DistribMeasurer(seed=seed, workdir=workdir, device=device)
        rung0 = 1.0                         # episodes
    else:
        raise ValueError(f"unknown spec {spec!r} (train | serve | distrib)")
    say(f"[{spec}] sweeping {len(grid)} arms (quick={quick})")
    try:
        result = successive_halving(
            grid, measurer.measure, rung0_window=rung0,
            max_rungs=2 if quick else 4, log_fn=log_fn)
        out = {
            "spec": spec,
            "arms": len(grid),
            "best": result["best"],
            "rungs": result["rungs"],
            "sweep_wall_s": round(result["wall_s"], 3),
            "trials": result["trials"],
        }
        best_trial = max(
            (t for t in result["trials"] if t["arm"] == result["best"]),
            key=lambda t: t["window"])
        out["best_objective"] = best_trial["objective"]
        out["best_detail"] = {k: v for k, v in best_trial.items()
                              if k != "arm"}
        if exhaustive:
            full_window = result["top_window"] * 2
            t0 = time.perf_counter()
            rows = []
            ex_measure_s = 0.0
            for arm in grid:
                best = None
                for _ in range(2):
                    res = measurer.measure(arm, full_window)
                    ex_measure_s += res.get("elapsed_s", 0.0)
                    if best is None or res["objective"] > best["objective"]:
                        best = res
                rows.append({"arm": arm, "window": full_window, **best})
            ex_best = max(rows, key=lambda r: r["objective"])
            chosen = next(r for r in rows if r["arm"] == result["best"])
            out["exhaustive"] = {
                "window": full_window,
                "trials_per_arm": 2,
                "wall_s": round(time.perf_counter() - t0, 3),
                "measure_s": round(ex_measure_s, 3),
                "sweep_measure_s": round(result["measure_s"], 3),
                "best": ex_best["arm"],
                "best_objective": ex_best["objective"],
                "chosen_objective_at_full_window": chosen["objective"],
                "chosen_vs_best": round(
                    chosen["objective"] / max(ex_best["objective"], 1e-9),
                    4),
                "sweep_cost_frac": round(
                    result["measure_s"] / max(ex_measure_s, 1e-9), 4),
                "rows": rows,
            }
        return out
    finally:
        measurer.close()


def run_autotune(specs=("train", "serve"), *, quick: bool = False,
                 out_path: str = "tuned_profile.json", seed: int = 0,
                 exhaustive: bool = False, device: str | None = None,
                 log_fn=None) -> dict:
    """Sweep every requested spec on ``device`` (CUDA when None; raises
    without one) and publish the merged profile."""
    from sharetrade_tpu_torch.device import resolve_device
    device = str(resolve_device(device))
    say = log_fn or (lambda msg: log.info("%s", msg))
    knobs: dict = {}
    objectives: dict = {}
    results: dict = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="autotune-") as workdir:
        for spec in specs:
            res = run_spec(spec, quick=quick, seed=seed, workdir=workdir,
                           exhaustive=exhaustive, device=device,
                           log_fn=log_fn)
            results[spec] = res
            knobs.update(res["best"])
            objectives[spec] = {
                "objective": res["best_objective"],
                **{k: v for k, v in res["best_detail"].items()
                   if k not in ("objective", "trials")},
            }
    profile = tuning.build_profile(
        knobs, objectives=objectives,
        trials=[{"spec": s, "trials": list(r["trials"])}
                for s, r in results.items()],
        seed=seed, device=device,
        notes=(f"tools/torch_autotune.py quick={quick} device={device} "
               f"specs={','.join(specs)}"))
    tuning.write_profile(out_path, profile)
    say(f"tuned profile written: {out_path} knobs={knobs}")
    return {
        "out": out_path,
        "knobs": knobs,
        "fingerprint": profile["fingerprint"],
        "objectives": objectives,
        "wall_s": round(time.perf_counter() - t0, 3),
        "specs": {s: {k: v for k, v in r.items() if k != "trials"}
                  for s, r in results.items()},
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--spec", default="train,serve",
                        help="comma list of train,serve,distrib")
    parser.add_argument("--quick", action="store_true",
                        help="tiny grid, seconds-scale windows")
    parser.add_argument("--out", default="tuned_profile.json",
                        help="profile output path (atomic rename)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--exhaustive", action="store_true",
                        help="also measure the full grid at twice the "
                             "final window (the hand-sweep baseline)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' to run "
                             "without a GPU)")
    parser.add_argument("--json", action="store_true",
                        help="print one machine-readable summary line")
    args = parser.parse_args(argv)
    specs = tuple(s.strip() for s in args.spec.split(",") if s.strip())
    say = (lambda msg: None) if args.json else (
        lambda msg: print(msg, flush=True))
    from sharetrade_tpu_torch.device import resolve_device
    try:
        device = str(resolve_device(args.device))
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    summary = run_autotune(
        specs, quick=args.quick, out_path=args.out, seed=args.seed,
        exhaustive=args.exhaustive, device=device, log_fn=say)
    if args.json:
        print(json.dumps(summary))
    else:
        print(json.dumps({k: v for k, v in summary.items()
                          if k != "specs"}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
