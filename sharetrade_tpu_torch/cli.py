"""Command-line driver of the PyTorch/CUDA port.

    python -m sharetrade_tpu_torch.cli train [--config cfg.json]
        [--set section.key=value ...] [--symbol MSFT] [--start D] [--end D]
        [--device cuda|cpu] [--params state.npz | --resume] [--eval]
        [--eval-best]
    python -m sharetrade_tpu_torch.cli serve [--config cfg.json]
        [--set section.key=value ...] [--symbol MSFT] [--start D] [--end D]
        [--duration S] [--sessions N] [--rate QPS] [--device cuda|cpu]
        [--params p.npz]
    python -m sharetrade_tpu_torch.cli query [--config cfg.json]
        [--set section.key=value ...] [--symbol MSFT] [--start D] [--end D]

Every command reads its prices through the event-sourced data service
(``data/service.py``): fetches are journaled to
``<data.journal_dir>/price-events.journal`` (``journal/`` under the cwd by
default), in the JAX package's format, and a later run recovers its cache
from there. ``train`` and ``serve`` close the service on every exit, a
SIGTERM's included, so the journal's writer lock is released.

``query`` prints one JSON line, as the JAX package's ``cli query`` does:
``symbol``, ``rows`` in the requested range, and its ``first`` and
``last`` dates. It touches no device.

``train`` runs the training orchestrator (runtime/orchestrator.py) over the
symbol's prices (several symbols, ``--symbol MSFT,AAPL``: their (A, T) price
matrix on the common dates, ``data/ingest.align_series``, and the
multi-asset portfolio env) until ``runtime.episodes`` episodes are done, as the JAX
package's ``cli train`` does: the reference's final log line ("The average
of the portfolios: ..."), then one JSON line with ``avg_portfolio``,
``std_portfolio``, ``env_steps``, ``updates``, ``agent_steps_per_sec``,
``elapsed_s``, ``restarts`` (the supervised restarts the run took), and the
run's CUDA kernel launches (``kernel_launches``; 0 on the CPU). ``--eval``
adds the greedy evaluation (``eval_portfolio``, ``eval_reward_sum``; under
``runtime.keep_best_eval`` a better policy is kept as ``tag_best``),
``--eval-best`` the evaluation of ``tag_best`` (``best_*``). Checkpoints go
to ``runtime.checkpoint_dir``. The state comes from a seeded init
(``seed``), from ``--resume`` (the newest intact checkpoint there, or
``tag_preempt`` when it is at least as new; none is an error, exit 1), or
from ``--params``: an ``.npz`` of a whole training state
(``convert.save_train_state_npz``, from either package) or of a params tree
alone (then the optimizer state starts fresh). SIGTERM/SIGINT stops at the
next chunk boundary, writes ``tag_preempt`` and exits 75.

``serve`` runs the continuous-batching engine (serve/engine.py) on the
model the configured learner trains (``learner.algo`` picks the Q-head or
the actor-critic heads, as in the JAX package; over the first symbol of
``--symbol``, as there) under synthetic session load (serve/driver.py):
closed loop (``serve.max_batch`` sessions in flight), or open loop at
``--rate`` arrivals per second, as the JAX package's ``cli serve`` does: a
``serving_ready`` JSON line once the engine is warm, then one summary JSON
line. Weights come from ``--params``, an ``.npz`` of a params tree
(``convert.save_npz``, from either package), else from the training run's
checkpoints in ``runtime.checkpoint_dir``: ``tag_<serve.swap_tag>``
(``tag_best``), then the newest intact step, then (loudly) a seeded fresh
init. ``params_step`` in the ready line is the checkpoint's update count (0
for ``--params`` and a fresh init); in the summary, that of the weights
serving at the end. A checkpoint directory of the JAX package is passed
over and left untouched (the two packages want separate
``runtime.checkpoint_dir`` values). With ``serve.swap_poll_s`` > 0 (the
default, 5 s) the weight-swap watcher (serve/swap.py) polls the tag and
swaps newer weights in between ticks; with ``--params`` only a save newer
than the tag at start replaces them. After a clean stop, a configured spill
tier (``serve.spill_dir``) receives every surviving session carry.
SIGTERM/SIGINT drains in-flight requests and exits 75. With
``tuning.serve_controller`` the online controller (serve/controller.py)
holds ``tuning.target_p99_ms`` by moving ``serve.batch_timeout_ms`` and
``serve.max_queue`` below their configured values, every
``tuning.controller_interval_s``; it stops after the drain. The summary
carries the JAX summary's telemetry keys: ``controller_adjustments``, the
per-stage p99s of the engine's histograms (``stage_p99_ms``), the three
slowest requests with their stage split (``slowest``) and, with
``obs.slo_*`` set, the last burn rates (``slo_availability_burn``,
``slo_latency_burn``). ``obs.enabled`` is refused.

``train`` and ``serve`` resolve ``tuning.profile`` (a tuned profile from
``tools/torch_autotune.py``) as the JAX package does: registered knobs
still at their defaults take the profile's values, explicit ones win.

A ``ConfigError`` (a refused knob, an impossible value; a missing, torn or
foreign profile is a ``ProfileError``) exits 2 with its message.

The device is ``cuda`` unless ``--device`` says otherwise; without a GPU
and without ``--device cpu`` the command fails with a message saying so.
Not yet ported: ``actor``, ``learner``, ``fleet``, ``obs``, ``--mesh``
and ``--listen``.
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
    from sharetrade_tpu_torch.tuning import apply_profile
    cfg = (FrameworkConfig.from_file(args.config) if args.config
           else FrameworkConfig())
    if args.set:
        cfg = cfg.apply_overrides(args.set)
    # File and --set values are the explicit tier and win; registered knobs
    # still at their defaults take the tuned profile's values.
    return apply_profile(cfg)


def cmd_train(args) -> int:
    from sharetrade_tpu_torch.convert import load_npz, load_train_state_npz
    from sharetrade_tpu_torch.data.ingest import align_series
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
    orch = service = None
    preempt_at: list[float] = []
    grace = cfg.runtime.preempt_grace_s

    def _grace_expired():
        log.error("preemption grace (%.1fs) expired before the chunk "
                  "boundary; hard exit", grace)
        os._exit(EXIT_PREEMPTED)

    def _on_signal(signum, frame):
        if not preempt_at:
            log.warning("received %s; stopping at the next chunk boundary",
                        signal.Signals(signum).name)
            preempt_at.append(time.monotonic())
            watchdog = threading.Timer(grace + 5.0, _grace_expired)
            watchdog.daemon = True
            watchdog.start()
        else:
            log.warning("received %s during the drain; hard exit",
                        signal.Signals(signum).name)
            os._exit(EXIT_PREEMPTED)
        if orch is not None:
            orch.request_preempt()

    prev_handlers = {s: signal.signal(s, _on_signal)
                     for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        symbols = [s.strip() for s in args.symbol.split(",") if s.strip()]
        service = PriceDataService(config=cfg.data)
        if len(symbols) > 1:
            # The multi-asset portfolio: the symbols on their common dates.
            prices = align_series([
                service.request(s, args.start, args.end).series
                for s in symbols])
            log.info("loaded %s prices for %d assets %s", prices.shape,
                     len(symbols), symbols)
        else:
            prices = service.request(symbols[0], args.start,
                                     args.end).series.prices
            log.info("loaded %d prices for %s", len(prices), symbols[0])
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
        try:
            orch.send_training_data(prices, resume=args.resume,
                                    train_state=train_state, params=params)
        except FileNotFoundError as exc:
            log.error("--resume: %s (train without --resume first)", exc)
            return 1
        # The loop runs on this, the main thread (signals still reach it
        # between bytecodes; the grace watchdog is a timer thread): on the
        # card the chunk's capture runs slower on a second thread
        # (tools/torch_capture_thread.py, PERF.md section 6).
        orch.start_training(background=False)
        elapsed = time.perf_counter() - t0
        done = orch.is_everything_done()
        if orch.preempted or (preempt_at
                              and done.state is not ReplyState.COMPLETED):
            log.warning("run preempted after %d chunks; resume with --resume "
                        "(emergency checkpoint: %s)", orch.chunks,
                        "written" if orch.preempt_saved
                        else "not confirmed — the latest cadence checkpoint "
                             "is the resume point")
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
        result = {
            "avg_portfolio": avg.value,
            "std_portfolio": std.value,
            "env_steps": snap.get("env_steps"),
            "updates": snap.get("updates"),
            "agent_steps_per_sec": agent_steps / max(elapsed, 1e-9),
            "elapsed_s": elapsed,
            "restarts": orch.restarts,
        }
        if args.eval:
            result.update(orch.evaluate())
        if args.eval_best:
            try:
                best = orch.evaluate_best()
            except FileNotFoundError:
                log.warning("--eval-best: no retained best checkpoint "
                            "(enable runtime.keep_best_eval and run --eval)")
            else:
                result.update({f"best_{k}": v for k, v in best.items()})
        result["kernel_launches"] = {**attention.launch_counts,
                                     **fused_update.launch_counts}
        print(json.dumps(result), flush=True)
        return 0
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if orch is not None:
            orch.stop()
        if service is not None:
            service.close()


def _checkpoints(cfg):
    """The run's checkpoint manager, or None while ``runtime.checkpoint_dir``
    does not exist (serving creates no directory of its own)."""
    from sharetrade_tpu_torch.checkpoint import CheckpointManager

    directory = cfg.runtime.checkpoint_dir
    if not os.path.isdir(directory):
        return None
    return CheckpointManager(
        directory, keep=cfg.runtime.keep_checkpoints,
        fsync=cfg.checkpoint.fsync, precision_mode=cfg.precision.mode)


def _serve_boot_params(cfg, template, manager):
    """Initial serving weights: the training run's tagged policy
    (``serve.swap_tag``, ``tag_best``) when there is one, else its newest
    intact step checkpoint, else ``template`` (a fresh init, loudly: an
    untrained policy serves finite garbage). A tag the JAX package wrote is
    passed over and left as it is (the step walk-back skips such dirs too).
    Returns ``(params, step, meta)``: ``step`` the checkpoint's update count,
    ``meta`` the tag's metadata when the tag served (the swap watcher's
    first seen stamp), else None."""
    from sharetrade_tpu_torch.checkpoint import ForeignCheckpointError
    from sharetrade_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    if manager is not None:
        try:
            params, meta = manager.restore_tagged(template, cfg.serve.swap_tag)
            return (params, int(meta.get("updates", meta.get("step", 0)) or 0),
                    meta)
        except FileNotFoundError:
            pass
        except ForeignCheckpointError as exc:
            log.warning("passing over tag_%s: %s", cfg.serve.swap_tag, exc)
        try:
            params, step = manager.restore(template)
            return params, int(step), None
        except FileNotFoundError:
            pass
    log.warning("no checkpoint of this package under %s; serving a seeded "
                "fresh-initialised (UNTRAINED) policy",
                cfg.runtime.checkpoint_dir)
    return template, 0, None


def _serve_summary(engine, registry, stats, *, device, drained: bool,
                   stopped_clean: bool, spill_pageout) -> dict:
    """``cli serve``'s summary line: the load's numbers, the engine's
    counters, and the JAX summary's keys (the session tiers' keys only when
    their tier ran, the telemetry keys only when they have a value)."""
    from sharetrade_tpu_torch.obs import serve_stage_p99s
    from sharetrade_tpu_torch.ops.attention import launch_counts

    counters = dict(engine.counters)
    reg = registry.counters()

    def total(name: str) -> int:
        return int(reg.get(name, 0))

    summary = {
        **stats,
        "params_step": engine.params_step,
        "device": str(device),
        "requests": counters["requests"],
        "prefills": counters["cold_rows"],
        "warm_rows": counters["warm_rows"],
        "cold_batches": counters["cold_batches"],
        "warm_batches": counters["warm_batches"],
        "generic_batches": counters["generic_batches"],
        "evictions": counters["evictions"],
        "queue_rejected": total("serve_queue_rejected_total"),
        "swaps": total("serve_swaps_total"),
        "swap_rejected": total("serve_swap_rejected_total"),
        "swap_breaker_opens": total("serve_swap_breaker_opens_total"),
        "shed": total("serve_shed_total"),
        "deadline_expired": total("serve_deadline_expired_total"),
        "restarts": total("serve_restarts_total"),
        "controller_adjustments": total(
            "serve_controller_adjustments_total"),
        "flash_fwd_launches": launch_counts["flash_fwd"],
        "drained": drained,
        "stopped_clean": stopped_clean,
        "engine_failed": engine.failed is not None,
    }
    warm = {k: total(f"serve_warm_{k}_total")
            for k in ("parks", "hits", "misses", "demotions")}
    if warm["parks"] or warm["hits"] or warm["misses"]:
        summary.update({f"warm_{k}": v for k, v in warm.items()})
    if spill_pageout is not None and any(spill_pageout.values()):
        summary["spill_pageout"] = spill_pageout
    if total("serve_spill_puts_total") or total("serve_spill_hits_total"):
        summary.update(
            spill_puts=total("serve_spill_puts_total"),
            spill_hits=total("serve_spill_hits_total"),
            adopt_warm=total("serve_adopt_warm_total"),
            adopt_cold=total("serve_adopt_cold_total"),
            spill_corrupt=total("serve_spill_corrupt_total"))
    # Which stage owns the tail, and the slowest requests themselves.
    stage_p99 = serve_stage_p99s(registry)
    if stage_p99:
        summary["stage_p99_ms"] = stage_p99
    slowest = engine.exemplars()[:3]
    if slowest:
        summary["slowest"] = slowest
    for key, gauge in (("slo_availability_burn",
                        "serve_slo_availability_burn"),
                       ("slo_latency_burn", "serve_slo_latency_burn")):
        value = registry.latest(gauge)
        if value is not None:
            summary[key] = round(value, 4)
    return summary


def cmd_serve(args) -> int:
    import torch

    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.convert import load_npz
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.device import resolve_device
    from sharetrade_tpu_torch.env.trading import make_trading_env
    from sharetrade_tpu_torch.precision import policy_from_config
    from sharetrade_tpu_torch.runtime.orchestrator import (
        SERVE_REFUSED, check_ported)
    from sharetrade_tpu_torch.serve import (
        ServeController, ServeEngine, WeightSwapWatcher)
    from sharetrade_tpu_torch.serve.driver import (
        make_sessions, run_closed_loop, run_open_loop)
    from sharetrade_tpu_torch.utils.logging import get_logger
    from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

    log = get_logger("cli")
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    cfg = _load_config(args)
    check_ported(cfg, SERVE_REFUSED, mesh=False)

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
    engine = service = watcher = controller = None
    try:
        service = PriceDataService(config=cfg.data)
        prices = service.request(args.symbol.split(",")[0].strip(),
                                 args.start, args.end).series.prices
        # The model the configured learner trains (its Q-head or its
        # actor-critic heads), as the JAX package's cli serve builds it.
        model = build_agent(cfg, make_trading_env(
            prices, window=cfg.env.window,
            initial_budget=cfg.env.initial_budget,
            initial_shares=cfg.env.initial_shares, device=device),
            device=device).model
        template = model.init(torch.Generator().manual_seed(cfg.seed))
        manager = _checkpoints(cfg)
        if args.params:
            params, step = load_npz(args.params, device=device), 0
            # Only a save newer than the tag as it stands now replaces the
            # weights passed in.
            boot_meta = (manager.tagged_metadata(cfg.serve.swap_tag)
                         if manager is not None else None)
        else:
            params, step, boot_meta = _serve_boot_params(cfg, template,
                                                         manager)
        registry = MetricsRegistry()
        engine = ServeEngine(model, cfg.serve, params, params_step=step,
                             precision=policy_from_config(cfg.precision),
                             registry=registry, obs_cfg=cfg.obs)
        engine.warmup()
        if cfg.tuning.serve_controller:
            # Hold tuning.target_p99_ms by moving batch_timeout_ms and
            # max_queue below their configured values.
            controller = ServeController(
                engine, target_p99_ms=cfg.tuning.target_p99_ms,
                interval_s=cfg.tuning.controller_interval_s).start()
        if cfg.serve.swap_poll_s > 0:
            watcher = WeightSwapWatcher(
                engine, manager or (lambda: _checkpoints(cfg)), template,
                tag=cfg.serve.swap_tag, poll_s=cfg.serve.swap_poll_s,
                seen_meta=boot_meta,
                breaker_failures=cfg.serve.swap_breaker_failures,
                breaker_cooldown_s=cfg.serve.swap_breaker_cooldown_s,
            ).start()
        print(json.dumps({"event": "serving_ready",
                          "params_step": step,
                          "model": model.name, "device": str(device),
                          "max_batch": cfg.serve.max_batch,
                          "slots": cfg.serve.slots,
                          "swap_watcher": watcher is not None}), flush=True)

        sessions = make_sessions(prices, cfg.env.window, args.sessions,
                                 seed=cfg.seed)
        if args.rate > 0:
            stats = run_open_loop(engine, sessions, rate_qps=args.rate,
                                  duration_s=args.duration, stop=stop_evt)
        else:
            stats = run_closed_loop(engine, sessions,
                                    concurrency=cfg.serve.max_batch,
                                    duration_s=args.duration, stop=stop_evt)
        grace = cfg.runtime.preempt_grace_s
        drained = engine.drain(timeout_s=grace * 0.5)
        if controller is not None:
            controller.stop()
        if watcher is not None:
            watcher.stop()
        stopped_clean = engine.stop(
            drain=False, timeout_s=min(max(grace / 8.0, 1.0), grace / 6.0))
        # With the threads stopped, seal every surviving carry into the
        # spill arena (no-op without one); a failed page-out only costs
        # adoptions, never the clean shutdown.
        spill_pageout = None
        if stopped_clean:
            try:
                spill_pageout = engine.page_out_all()
            except Exception:   # noqa: BLE001
                log.exception("drain page-out failed; this engine's "
                              "sessions will restart cold elsewhere")
        summary = _serve_summary(engine, registry, stats, device=device,
                                 drained=drained,
                                 stopped_clean=stopped_clean,
                                 spill_pageout=spill_pageout)
        if preempted:
            summary["preempted"] = True
        print(json.dumps(summary), flush=True)
        if preempted:
            return EXIT_PREEMPTED
        return 0 if stopped_clean else 1
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if controller is not None:
            controller.stop()
        if watcher is not None:
            watcher.stop()
        if engine is not None:
            engine.stop(drain=False, timeout_s=5.0)
        if service is not None:
            service.close()


def cmd_query(args) -> int:
    from sharetrade_tpu_torch.data.service import PriceDataService

    cfg = _load_config(args)
    service = PriceDataService(config=cfg.data)
    try:
        response = service.request(args.symbol, args.start, args.end)
    finally:
        service.close()
    series = response.series
    print(json.dumps({
        "symbol": response.symbol,
        "rows": len(series),
        "first": str(series.dates[0]) if len(series) else None,
        "last": str(series.dates[-1]) if len(series) else None,
    }), flush=True)
    return 0


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
    boot = p.add_mutually_exclusive_group()
    boot.add_argument("--params", default=None,
                      help=".npz of a training state (convert."
                           "save_train_state_npz) or of a params tree; "
                           "default a seeded init")
    boot.add_argument("--resume", action="store_true",
                      help="continue from the newest intact checkpoint in "
                           "runtime.checkpoint_dir (or tag_preempt)")
    p.add_argument("--eval", action="store_true",
                   help="greedy evaluation of the final policy")
    p.add_argument("--eval-best", action="store_true",
                   help="greedy evaluation of the retained tag_best policy")
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser("serve", help="continuous-batching inference under "
                                     "synthetic closed- or open-loop load")
    _common(p)
    p.add_argument("--duration", type=float, default=10.0,
                   help="seconds to serve the synthetic load (SIGTERM "
                        "drains and exits 75 earlier)")
    p.add_argument("--sessions", type=int, default=512,
                   help="synthetic user sessions to replay")
    p.add_argument("--rate", type=float, default=0.0,
                   help="open-loop arrivals per second (default 0: closed "
                        "loop, serve.max_batch sessions in flight)")
    p.add_argument("--params", default=None,
                   help=".npz of a params tree (convert.save_npz); default "
                        "the run's checkpoints (tag_best, then the newest "
                        "step), else a seeded init")
    p.set_defaults(fn=cmd_serve)
    p = sub.add_parser("query", help="one symbol's price rows through the "
                                     "data service (journaled)")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--set", action="append", default=[],
                   metavar="SECTION.KEY=VALUE", help="config override")
    p.add_argument("--symbol", default="MSFT")
    p.add_argument("--start", default=None)
    p.add_argument("--end", default=None)
    p.set_defaults(fn=cmd_query)
    args = parser.parse_args(argv)
    from sharetrade_tpu_torch.config import ConfigError
    from sharetrade_tpu_torch.utils.logging import configure
    configure()
    try:
        return args.fn(args)
    except ConfigError as exc:
        print(f"error: {type(exc).__name__}: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
