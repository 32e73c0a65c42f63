"""Command-line driver of the PyTorch/CUDA port.

    python -m sharetrade_tpu_torch.cli train [--config cfg.json]
        [--set section.key=value ...] [--symbol MSFT] [--start D] [--end D]
        [--device cuda|cpu] [--params state.npz]
    python -m sharetrade_tpu_torch.cli serve [--config cfg.json]
        [--set section.key=value ...] [--symbol MSFT] [--start D] [--end D]
        [--duration S] [--sessions N] [--device cuda|cpu] [--params p.npz]

``train`` runs the training orchestrator (runtime/orchestrator.py) over the
symbol's prices until ``runtime.episodes`` episodes are done, as the JAX
package's ``cli train`` does: the reference's final log line ("The average
of the portfolios: ..."), then one JSON line with ``avg_portfolio``,
``std_portfolio``, ``env_steps``, ``updates``, ``agent_steps_per_sec``,
``elapsed_s`` and ``restarts`` (always 0: supervision is not ported), and
the run's CUDA kernel launches (``kernel_launches``; 0 on the CPU). The
state comes from a seeded init (``seed``) or from ``--params``: an ``.npz``
of a whole training state (``convert.save_train_state_npz``, from either
package) or of a params tree alone (then the optimizer state starts fresh).
SIGTERM/SIGINT stops at the next chunk boundary and exits 75.

``serve`` runs the continuous-batching engine (serve/engine.py) on the
configured model under synthetic closed-loop session load
(serve/driver.py), as the JAX package's ``cli serve`` does: a
``serving_ready`` JSON line once the engine is warm, then one summary JSON
line. Weights come from a seeded init (``seed``) or from ``--params``, an
``.npz`` of a params tree (``convert.save_npz``, from either package).
SIGTERM/SIGINT drains in-flight requests and exits 75.

The device is ``cuda`` unless ``--device`` says otherwise; without a GPU
and without ``--device cpu`` the command fails with a message saying so.
Not yet ported: ``query``, ``actor``, ``learner``, ``fleet``, ``obs``,
checkpoint restore and ``--resume``, ``--eval``, ``--mesh``, the
tuned-profile resolution, ``--rate`` and ``--listen``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import threading
import time

#: Exit code of a preempted (SIGTERM/SIGINT) run — EX_TEMPFAIL, as in the
#: JAX package's cli.
EXIT_PREEMPTED = 75


def _load_config(args):
    from sharetrade_tpu_torch.config import FrameworkConfig
    cfg = (FrameworkConfig.from_file(args.config) if args.config
           else FrameworkConfig())
    if args.set:
        cfg = cfg.apply_overrides(args.set)
    return cfg


def cmd_train(args) -> int:
    from sharetrade_tpu_torch.convert import load_npz, load_train_state_npz
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.device import resolve_device
    from sharetrade_tpu_torch.ops import attention, fused_update
    from sharetrade_tpu_torch.runtime.lifecycle import ReplyState
    from sharetrade_tpu_torch.runtime.orchestrator import Orchestrator
    from sharetrade_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    cfg = _load_config(args)
    orch = None
    preempt_at: list[float] = []

    def _on_signal(signum, frame):
        if not preempt_at:
            log.warning("received %s; stopping at the next chunk boundary",
                        signal.Signals(signum).name)
            preempt_at.append(time.monotonic())
        else:
            log.warning("received %s during the drain; hard exit",
                        signal.Signals(signum).name)
            os._exit(EXIT_PREEMPTED)
        if orch is not None:
            orch.request_preempt()

    prev_handlers = {s: signal.signal(s, _on_signal)
                     for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        symbol = args.symbol.split(",")[0].strip()
        prices = PriceDataService(config=cfg.data).request(
            symbol, args.start, args.end).series.prices
        log.info("loaded %d prices for %s", len(prices), symbol)
        orch = Orchestrator(cfg, device=device)
        if preempt_at:
            orch.request_preempt()
        train_state = params = None
        if args.params:
            train_state = load_train_state_npz(args.params, device=device,
                                               seed=cfg.seed)
            if train_state is None:        # a bare params tree
                params = load_npz(args.params, device=device)
        t0 = time.perf_counter()
        orch.send_training_data(prices, train_state=train_state,
                                params=params)
        orch.start_training(background=True)
        grace = cfg.runtime.preempt_grace_s
        while not orch.wait(timeout=cfg.runtime.poll_interval_s):
            if preempt_at and time.monotonic() - preempt_at[0] > grace + 5.0:
                log.error("preemption grace (%.1fs) expired before the "
                          "chunk boundary; hard exit", grace)
                os._exit(EXIT_PREEMPTED)
        elapsed = time.perf_counter() - t0
        done = orch.is_everything_done()
        if orch.preempted or (preempt_at
                              and done.state is not ReplyState.COMPLETED):
            log.warning("run preempted after %d chunks", orch.chunks)
            return EXIT_PREEMPTED
        avg, std = orch.get_avg(), orch.get_std()
        if done.state is not ReplyState.COMPLETED or not avg.ok:
            log.error("training did not complete: %s (last error: %r)",
                      done, orch.last_error)
            return 1
        snap = orch.snapshot()
        agent_steps = snap.get("env_steps", 0.0) * cfg.parallel.num_workers
        # The reference's final log line (ShareTradeHelper.scala:46).
        log.info("The average of the portfolios: %.4f, the standard "
                 "deviation: %.4f", avg.value, std.value)
        print(json.dumps({
            "avg_portfolio": avg.value,
            "std_portfolio": std.value,
            "env_steps": snap.get("env_steps"),
            "updates": snap.get("updates"),
            "agent_steps_per_sec": agent_steps / max(elapsed, 1e-9),
            "elapsed_s": elapsed,
            "restarts": orch.restarts,
            "kernel_launches": {**attention.launch_counts,
                                **fused_update.launch_counts},
        }), flush=True)
        return 0
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if orch is not None:
            orch.stop()


def cmd_serve(args) -> int:
    import torch

    from sharetrade_tpu_torch.convert import load_npz
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.device import resolve_device
    from sharetrade_tpu_torch.env.trading import obs_dim
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.ops.attention import launch_counts
    from sharetrade_tpu_torch.precision import policy_from_config
    from sharetrade_tpu_torch.serve import ServeEngine
    from sharetrade_tpu_torch.serve.engine import PARAMS_STEP
    from sharetrade_tpu_torch.serve.driver import make_sessions, run_closed_loop
    from sharetrade_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    cfg = _load_config(args)

    stop_evt = threading.Event()
    preempted: list[float] = []

    def _on_signal(signum, frame):
        if not preempted:
            log.warning("received %s; draining in-flight requests",
                        signal.Signals(signum).name)
            preempted.append(time.monotonic())
            stop_evt.set()
        else:
            log.warning("received %s during the drain; hard exit",
                        signal.Signals(signum).name)
            os._exit(EXIT_PREEMPTED)

    prev_handlers = {s: signal.signal(s, _on_signal)
                     for s in (signal.SIGTERM, signal.SIGINT)}
    engine = None
    try:
        service = PriceDataService(config=cfg.data)
        prices = service.request(args.symbol.split(",")[0].strip(),
                                 args.start, args.end).series.prices
        model = build_model(cfg.model, obs_dim(cfg.env.window), device=device)
        if args.params:
            params = load_npz(args.params, device=device)
        else:
            log.warning("no --params; serving a seeded fresh-initialised "
                        "(UNTRAINED) policy")
            params = model.init(torch.Generator().manual_seed(cfg.seed))
        engine = ServeEngine(model, cfg.serve, params,
                             precision=policy_from_config(cfg.precision))
        engine.warmup()
        print(json.dumps({"event": "serving_ready",
                          "params_step": PARAMS_STEP,
                          "model": model.name, "device": str(device),
                          "max_batch": cfg.serve.max_batch,
                          "slots": cfg.serve.slots}), flush=True)

        sessions = make_sessions(prices, cfg.env.window, args.sessions,
                                 seed=cfg.seed)
        stats = run_closed_loop(engine, sessions,
                                concurrency=cfg.serve.max_batch,
                                duration_s=args.duration, stop=stop_evt)
        grace = cfg.runtime.preempt_grace_s
        drained = engine.drain(timeout_s=grace * 0.5)
        stopped_clean = engine.stop(drain=False,
                                    timeout_s=max(grace / 8.0, 1.0))
        counters = dict(engine.counters)
        summary = {
            **stats,
            "params_step": PARAMS_STEP,
            "device": str(device),
            "requests": counters["requests"],
            "prefills": counters["cold_rows"],
            "warm_rows": counters["warm_rows"],
            "cold_batches": counters["cold_batches"],
            "warm_batches": counters["warm_batches"],
            "evictions": counters["evictions"],
            "queue_rejected": counters["rejected"],
            "flash_fwd_launches": launch_counts["flash_fwd"],
            "drained": drained,
            "stopped_clean": stopped_clean,
        }
        if preempted:
            summary["preempted"] = True
        print(json.dumps(summary), flush=True)
        if preempted:
            return EXIT_PREEMPTED
        return 0 if stopped_clean else 1
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if engine is not None:
            engine.stop(drain=False, timeout_s=5.0)


def _common(p) -> None:
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--set", action="append", default=[],
                   metavar="SECTION.KEY=VALUE", help="config override")
    p.add_argument("--symbol", default="MSFT")
    p.add_argument("--start", default=None)
    p.add_argument("--end", default=None)
    p.add_argument("--device", default=None,
                   help="torch device (default cuda; 'cpu' to run without "
                        "a GPU)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="sharetrade_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("train", help="train the configured learner until "
                                     "runtime.episodes are done")
    _common(p)
    p.add_argument("--params", default=None,
                   help=".npz of a training state (convert."
                        "save_train_state_npz) or of a params tree; default "
                        "a seeded init")
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser("serve", help="continuous-batching inference under "
                                     "synthetic closed-loop load")
    _common(p)
    p.add_argument("--duration", type=float, default=10.0,
                   help="seconds to serve the synthetic load (SIGTERM "
                        "drains and exits 75 earlier)")
    p.add_argument("--sessions", type=int, default=512,
                   help="synthetic user sessions to replay")
    p.add_argument("--params", default=None,
                   help=".npz of a params tree (convert.save_npz); default "
                        "a seeded init")
    p.set_defaults(fn=cmd_serve)
    args = parser.parse_args(argv)
    from sharetrade_tpu_torch.utils.logging import configure
    configure()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
