"""Command-line driver of the PyTorch/CUDA port.

    python -m sharetrade_tpu_torch.cli train [--config cfg.json]
        [--set section.key=value ...] [--symbol MSFT] [--start D] [--end D]
        [--device cuda|cpu] [--params state.npz | --resume] [--eval]
        [--eval-best]
    python -m sharetrade_tpu_torch.cli serve [--config cfg.json]
        [--set section.key=value ...] [--symbol MSFT] [--start D] [--end D]
        [--duration S] [--sessions N] [--rate QPS] [--device cuda|cpu]
        [--params p.npz] [--listen HOST:PORT]
    python -m sharetrade_tpu_torch.cli fleet [--config cfg.json]
        [--set section.key=value ...] [--symbol MSFT] [--start D] [--end D]
        [--engines N] [--autoscale] [--duration S] [--device cuda|cpu]
        [--learner [--resume]]
    python -m sharetrade_tpu_torch.cli learner [--config cfg.json]
        [--set section.key=value ...] [--symbol MSFT] [--start D] [--end D]
        [--device cuda|cpu] [--resume]
    python -m sharetrade_tpu_torch.cli actor --actor-id ID [--config cfg.json]
        [--set section.key=value ...] [--symbol MSFT] [--start D] [--end D]
        [--device cuda|cpu] [--max-chunks N]
    python -m sharetrade_tpu_torch.cli query [--config cfg.json]
        [--set section.key=value ...] [--symbol MSFT] [--start D] [--end D]
    python -m sharetrade_tpu_torch.cli obs [--dir obs] [--trace list|ID
        [--out trace.json]] [--history N]

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
``slo_latency_burn``).

``serve --listen HOST:PORT`` is the fleet's worker mode (fleet/frontend.py):
instead of synthetic load the engine serves the fleet wire protocol
(``POST /v1/submit``, ``GET /healthz``, ``GET /metrics``) on that address
(port 0: an ephemeral one), prints an ``engine_listening`` line (``host``,
``port``, ``pid``, ``proto_backend``, ``params_step``) once bound, and serves
for ``--duration`` seconds (0: until a signal). SIGTERM drains the
front-end, then the engine, then pages every carry out to the spill tier,
prints the summary (``mode: listen``) and exits 75.

``fleet`` boots the serving fleet (fleet/): ``fleet.num_engines``
(``--engines``) ``serve --listen`` workers on the same device under the
engine pool's supervision, the telemetry-driven router behind one public
front-end on ``fleet.host:fleet.port``, and with ``--autoscale`` the
autoscaler. The CUDA kernels are built once before any worker starts. It
prints ``fleet_ready`` (``port``, ``engines``, ``proto_backend``) once the
engines listen, serves for ``--duration`` seconds (0: until a signal), and
on SIGTERM drains the front-end and every engine, prints its summary
(``requests``, ``completed``, ``refused``, ``migrations``,
``engine_restarts``, ``engines_*``) and exits 75. With ``--learner`` (the
flywheel; ``learner.algo=dqn``) a DQN learner trains in the fleet's process
(``distrib.ingest_without_pool``): it ingests the transition journals that
served sessions write under ``distrib.actor_dir`` (``fleet/flywheel.py``)
and republishes ``tag_best``, which the engines' swap watchers take;
``fleet_ready`` says ``"learner": true``, and the summary adds
``learner_updates``, ``rows_ingested``, ``learner_restarts`` and the
learner's ``kernel_launches``.

``learner`` is the disaggregated topology's learner (``distrib.num_actors``
>= 1, ``learner.algo=dqn``): it supervises ``distrib.num_actors`` ``cli
actor`` processes on its device (``distrib/pool.py``: backoff respawns,
terminal failure, heartbeats, the ``scale`` file, ``status.json`` under
``distrib.actor_dir``) and trains on its main thread, ingesting every
actor's journal every ``distrib.ingest_every_updates`` updates and
republishing ``tag_best`` at each better greedy eval
(``runtime.eval_every_updates``) for the actors to swap in. It defaults
``data.journal_segment_records`` to 256 (bounded actor journals), prints
``learner_ready`` (``pid``, ``actors``, ``pool_dir``), and ends with one
summary line: ``env_steps``, ``updates``, ``elapsed_s``,
``learner_restarts``, ``actor_restarts``, ``rows_ingested``,
``actors_alive/backoff/failed/retired``, and the port's ``actor_feeds``
(rows ingested and cursor per actor) and ``kernel_launches``. ``--events
PATH`` appends its run events as JSON lines, each ingest tick's
``actor_feed_ingest`` with, per actor, the cursor read from, the one left
(``high_water``), the rows and the first record read (stamp, rows). An
actor's death never restarts the learner. SIGTERM drains both tiers (the
pool stops respawning, the learner writes ``tag_preempt``, every actor
drains its journal and retires) and exits 75; a second signal, or the grace
(``runtime.preempt_grace_s`` + 5 s) running out, kills every actor and
exits 75 at once.

``actor`` is one rollout actor (``distrib/actor.py``), normally spawned by
``learner``: weights from ``tag_best`` (then the newest step, then a seeded
init), epsilon-greedy chunks journaled to
``<distrib.actor_dir>/<actor-id>/transitions.journal``, a heartbeat beside
it. It prints ``actor_ready`` (``params_step``, ``journal``), then on a stop
(SIGTERM, or ``--max-chunks``) one summary line; SIGTERM drains and exits
75.

``train``, ``serve``, ``learner`` and ``actor`` resolve ``tuning.profile`` (a tuned profile from
``tools/torch_autotune.py``) as the JAX package does: registered knobs
still at their defaults take the profile's values, explicit ones win.

Telemetry (``--set obs.enabled=true``, ``obs.dir``; the JAX package's run
directory format): ``train`` and ``learner`` write through the
orchestrator (``manifest.json``, ``trace.jsonl``, ``metrics.jsonl``,
``metrics.prom``, ``flight_recorder.json`` on a supervision fault or a
preemption); ``serve`` (``--listen`` too) through the engine (request
spans, ``serve_exemplars.json``, its flight events); ``fleet`` writes the
router's run directory, defaults ``obs.span_dir`` to ``<obs.dir>/spans``
(``obs.span_proc`` ``fleet``; the workers journal there as
``engine-<id>`` with obs otherwise off), and its ``--learner`` writes to
``<obs.dir>/learner``. ``actor`` keeps obs off. ``obs`` summarises a run
directory written by either package (``--dir``), stitches a cross-process
trace from ``<dir>/spans`` (``--trace list`` or ``--trace ID``, ``--out``
for a Perfetto file) or summarises the fleet's telemetry history
(``--history N``, ``--dir`` the fleet's workdir); it touches no device.

A ``ConfigError`` (a refused knob, an impossible value; a missing, torn or
foreign profile is a ``ProfileError``) exits 2 with its message.
``obs.roofline`` and ``runtime.profile_dir`` are refused (ROADMAP item 13b).

The device is ``cuda`` unless ``--device`` says otherwise; without a GPU
and without ``--device cpu`` the command fails with a message saying so.
Not yet ported: ``--mesh``.
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
    from sharetrade_tpu_torch.obs import build_obs
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
    engine = service = watcher = controller = frontend = obs = None
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
        registry = MetricsRegistry(
            max_points=cfg.obs.max_metric_points or None)
        obs = build_obs(cfg, registry, device=device)
        engine = ServeEngine(model, cfg.serve, params, params_step=step,
                             precision=policy_from_config(cfg.precision),
                             registry=registry, obs=obs, obs_cfg=cfg.obs)
        engine.warmup()
        if cfg.tuning.serve_controller:
            # Hold tuning.target_p99_ms by moving batch_timeout_ms and
            # max_queue below their configured values.
            controller = ServeController(
                engine, target_p99_ms=cfg.tuning.target_p99_ms,
                interval_s=cfg.tuning.controller_interval_s,
                obs=obs).start()
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

        if args.listen:
            frontend = _listen(cfg, engine, registry, args.listen, step,
                               obs.spans)
            deadline = (time.monotonic() + args.duration
                        if args.duration > 0 else None)
            while not stop_evt.is_set():
                if deadline is not None and time.monotonic() >= deadline:
                    break
                stop_evt.wait(0.2)
            # The front-end first (the listener closes, in-flight requests
            # finish), then the engine below, then the page-out.
            frontend.drain(timeout_s=cfg.runtime.preempt_grace_s * 0.25)
            frontend.stop()
            stats = {"mode": "listen", "host": frontend.host,
                     "port": frontend.port}
        else:
            sessions = make_sessions(prices, cfg.env.window, args.sessions,
                                     seed=cfg.seed)
            if args.rate > 0:
                stats = run_open_loop(engine, sessions, rate_qps=args.rate,
                                      duration_s=args.duration,
                                      stop=stop_evt)
            else:
                stats = run_closed_loop(engine, sessions,
                                        concurrency=cfg.serve.max_batch,
                                        duration_s=args.duration,
                                        stop=stop_evt)
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
        obs.flush()
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
        if frontend is not None:
            frontend.stop()
        if controller is not None:
            controller.stop()
        if watcher is not None:
            watcher.stop()
        if engine is not None:
            engine.stop(drain=False, timeout_s=5.0)
        if obs is not None:
            obs.close()
        if service is not None:
            service.close()


def _listen(cfg, engine, registry, address: str, step: int, spans):
    """Serve ``engine`` on the fleet wire at ``address`` (``HOST:PORT``)
    and print the ``engine_listening`` line the engine pool waits for.
    ``spans`` (the run's span sink, ``obs.span_dir``): the engine's spans
    of traced requests are journaled there, parented under the router's
    attempt span from the wire headers (a sink-less tracer parses them)."""
    from sharetrade_tpu_torch.fleet import EngineBackend, ServeFrontend
    from sharetrade_tpu_torch.fleet import proto
    from sharetrade_tpu_torch.fleet.wire import WireTracer

    # The parse/render rung before the front-end starts ("native" falls
    # back to "py" with one loud line: the port has no native rung).
    proto.set_backend(cfg.fleet.proto_backend)
    host, _, port = address.rpartition(":")
    frontend = ServeFrontend(
        EngineBackend(engine, request_timeout_s=cfg.fleet.request_timeout_s,
                      spans=spans),
        registry, host=host or "127.0.0.1", port=int(port or 0),
        wire_backend=cfg.fleet.wire_backend,
        tracer=WireTracer() if spans is not None else None).start()
    print(json.dumps({"event": "engine_listening", "host": frontend.host,
                      "port": frontend.port, "pid": os.getpid(),
                      "proto_backend": proto.proto_backend,
                      "params_step": step}), flush=True)
    return frontend


def _share_host_cores(device, processes: int) -> None:
    """On the CPU a learner and its actors compute on the same cores: each
    of the ``processes`` takes an equal share of torch's intra-op threads.
    torch's default, a thread per core in every process, oversubscribes the
    host (a full-width DQN chunk took 0.6-1.3 s alone and more than 35 s
    beside two actors on 8 cores)."""
    if device.type == "cpu":
        import torch
        cores = len(os.sched_getaffinity(0))
        torch.set_num_threads(max(1, cores // max(1, processes)))


def cmd_actor(args) -> int:
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.device import resolve_device
    from sharetrade_tpu_torch.distrib.actor import RolloutActor
    from sharetrade_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    cfg = _load_config(args)
    if not args.actor_id:
        log.error("--actor-id is required")
        return 1
    _share_host_cores(device, cfg.distrib.num_actors + 1)
    workdir = os.path.join(cfg.distrib.actor_dir, args.actor_id)
    # The actor's data layer lives in ITS directory: sharing the learner's
    # journal_dir would contend for the price journal's writer lock.
    cfg.data.journal_dir = workdir
    # Telemetry stays with the learner; actor health flows through the
    # heartbeats to the pool's gauges.
    cfg.obs.enabled = False

    stop_evt = threading.Event()
    preempted: list[float] = []

    def _on_signal(signum, frame):
        if not preempted:
            log.warning("actor %s received %s; draining", args.actor_id,
                        signal.Signals(signum).name)
            preempted.append(time.monotonic())
            stop_evt.set()
        else:
            os._exit(EXIT_PREEMPTED)

    prev_handlers = {s: signal.signal(s, _on_signal)
                     for s in (signal.SIGTERM, signal.SIGINT)}
    service = None
    try:
        service = PriceDataService(config=cfg.data)
        prices = service.request(args.symbol.split(",")[0].strip(),
                                 args.start, args.end).series.prices
        actor = RolloutActor(cfg, prices, actor_id=args.actor_id,
                             workdir=workdir, device=device)
        print(json.dumps({"event": "actor_ready", "actor_id": args.actor_id,
                          "pid": os.getpid(),
                          "params_step": actor.params_step,
                          "journal": actor.journal_path,
                          "device": str(device)}), flush=True)
        summary = actor.run(stop_evt, max_chunks=args.max_chunks)
        print(json.dumps(summary), flush=True)
        return EXIT_PREEMPTED if preempted else 0
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if service is not None:
            service.close()


def cmd_learner(args) -> int:
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.device import resolve_device
    from sharetrade_tpu_torch.distrib.pool import ActorPool
    from sharetrade_tpu_torch.ops import attention, fused_update
    from sharetrade_tpu_torch.runtime.lifecycle import ReplyState
    from sharetrade_tpu_torch.runtime.orchestrator import Orchestrator
    from sharetrade_tpu_torch.utils.logging import EventLog, get_logger

    log = get_logger("cli")
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    cfg = _load_config(args)
    if cfg.distrib.num_actors < 1:
        log.error("cli learner needs distrib.num_actors >= 1 (got %d); use "
                  "cli train for the single-process loop",
                  cfg.distrib.num_actors)
        return 1
    if cfg.learner.algo != "dqn" and cfg.distrib.ingest_every_updates > 0:
        log.error("actor-feed ingest requires learner.algo=dqn (replay "
                  "buffer); got %r", cfg.learner.algo)
        return 1
    _share_host_cores(device, cfg.distrib.num_actors + 1)
    if cfg.data.journal_segment_records <= 0:
        # Single-file actor journals would grow without bound (retirement
        # needs rotation) and every ingest tick would re-decode the whole
        # history; the saved config carries this to the actors.
        cfg.data.journal_segment_records = 256
        log.info("distrib: defaulting data.journal_segment_records=256 "
                 "(rotation bounds the actor journals and the ingest reads)")
    orch = pool = service = None
    events = EventLog(args.events)
    preempt_at: list[float] = []
    grace = cfg.runtime.preempt_grace_s

    def _hard_exit():
        # os._exit skips every finally: an actor not killed now would roll
        # out forever with no supervisor.
        if pool is not None:
            pool.kill_all()
        os._exit(EXIT_PREEMPTED)

    def _grace_expired():
        log.error("preemption grace (%.1fs) expired before the drain "
                  "finished; hard exit", grace)
        _hard_exit()

    def _on_signal(signum, frame):
        if not preempt_at:
            log.warning("received %s; draining learner + actor pool",
                        signal.Signals(signum).name)
            preempt_at.append(time.monotonic())
            watchdog = threading.Timer(grace + 5.0, _grace_expired)
            watchdog.daemon = True
            watchdog.start()
        else:
            log.warning("received %s during the drain; hard exit",
                        signal.Signals(signum).name)
            _hard_exit()
        if pool is not None:
            # A group-wide TERM reaches the actors too: their graceful
            # exits are a drain, not crashes to respawn.
            pool.quiesce()
        if orch is not None:
            orch.request_preempt()

    prev_handlers = {s: signal.signal(s, _on_signal)
                     for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        service = PriceDataService(config=cfg.data)
        prices = service.request(args.symbol.split(",")[0].strip(),
                                 args.start, args.end).series.prices
        orch = Orchestrator(cfg, device=device, event_log=events)
        if preempt_at:
            orch.request_preempt()
        pool = ActorPool(cfg, registry=orch.metrics, symbol=args.symbol,
                         start=args.start, end=args.end,
                         device=str(device)).start()
        if preempt_at:
            pool.quiesce()
        print(json.dumps({"event": "learner_ready", "pid": os.getpid(),
                          "actors": cfg.distrib.num_actors,
                          "pool_dir": pool.dir, "device": str(device)}),
              flush=True)
        t0 = time.perf_counter()
        try:
            orch.send_training_data(prices, resume=args.resume)
        except FileNotFoundError as exc:
            log.error("--resume: %s (train without --resume first)", exc)
            return 1
        # The loop on this, the main thread, as cli train runs it (the
        # chunk's capture runs slower on a second thread).
        orch.start_training(background=False)
        elapsed = time.perf_counter() - t0
        done = orch.is_everything_done()
        pool.stop(grace_s=grace)
        snap = orch.snapshot()
        summary = {
            "env_steps": snap.get("env_steps"),
            "updates": snap.get("updates"),
            "elapsed_s": elapsed,
            "learner_restarts": orch.restarts,
            "actor_restarts": pool.restarts_total,
            "rows_ingested": int(orch.metrics.counters().get(
                "distrib_rows_ingested_total", 0)),
            **{f"actors_{k}": v for k, v in pool.counts().items()},
            "actor_feeds": orch.actor_feeds,
            "kernel_launches": {**attention.launch_counts,
                                **fused_update.launch_counts},
        }
        if orch.preempted or (preempt_at
                              and done.state is not ReplyState.COMPLETED):
            summary["preempted"] = True
            print(json.dumps(summary), flush=True)
            return EXIT_PREEMPTED
        if done.state is not ReplyState.COMPLETED:
            log.error("learner did not complete: %s (last error: %r)",
                      done, orch.last_error)
            print(json.dumps(summary), flush=True)
            return 1
        avg, std = orch.get_avg(), orch.get_std()
        if avg.ok:
            summary["avg_portfolio"] = avg.value
            summary["std_portfolio"] = std.value
        print(json.dumps(summary), flush=True)
        return 0
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if pool is not None:
            pool.stop(grace_s=10.0)
        if orch is not None:
            orch.stop()
        if service is not None:
            service.close()
        events.close()


def cmd_fleet(args) -> int:
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.data.service import PriceDataService
    from sharetrade_tpu_torch.device import resolve_device
    from sharetrade_tpu_torch.fleet import (
        EnginePool, FleetRouter, ServeFrontend, proto)
    from sharetrade_tpu_torch.fleet.autoscale import EngineAutoscaler
    from sharetrade_tpu_torch.fleet.wire import WireTracer
    from sharetrade_tpu_torch.obs import build_obs
    from sharetrade_tpu_torch.ops import attention, fused_update
    from sharetrade_tpu_torch.runtime.orchestrator import (
        SERVE_REFUSED, Orchestrator, check_ported)
    from sharetrade_tpu_torch.utils.logging import get_logger
    from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

    log = get_logger("cli")
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    cfg = _load_config(args)
    if args.engines:
        cfg.fleet.num_engines = args.engines
    if args.autoscale:
        cfg.fleet.autoscale = True
    check_ported(cfg, SERVE_REFUSED, mesh=False)
    learner_cfg = None
    if args.learner:
        # The flywheel's learner half: ingest the served sessions' journals
        # with no actor pool in this process.
        if cfg.learner.algo != "dqn":
            log.error("--learner requires learner.algo=dqn (replay "
                      "ingest); got %r", cfg.learner.algo)
            return 1
        if cfg.data.journal_segment_records <= 0:
            cfg.data.journal_segment_records = 256
        learner_cfg = FrameworkConfig.from_dict(cfg.to_dict())
        learner_cfg.distrib.ingest_without_pool = True
        if learner_cfg.obs.enabled:
            # The learner's own run directory beside the fleet's: two
            # exporters never share one manifest or metrics file.
            learner_cfg.obs.dir = os.path.join(cfg.obs.dir, "learner")
        check_ported(learner_cfg)
    if device.type == "cuda":
        # Once, before any worker starts: each worker would otherwise spend
        # its own compile inside fleet.startup_timeout_s.
        from sharetrade_tpu_torch.ops import cuda_build
        cuda_build.build_all()

    pool = router = frontend = autoscaler = orch = service = obs = None
    stop_evt = threading.Event()
    preempted: list[float] = []

    def _on_signal(signum, frame):
        if not preempted:
            log.warning("received %s; draining the fleet",
                        signal.Signals(signum).name)
            preempted.append(time.monotonic())
            stop_evt.set()
            if pool is not None:
                pool.quiesce()
            if orch is not None:
                orch.request_preempt()
        else:
            log.warning("received %s during the drain; hard exit",
                        signal.Signals(signum).name)
            if pool is not None:
                pool.kill_all()     # os._exit skips every finally
            os._exit(EXIT_PREEMPTED)

    prev_handlers = {s: signal.signal(s, _on_signal)
                     for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        registry = MetricsRegistry(
            max_points=cfg.obs.max_metric_points or None)
        if cfg.obs.enabled and cfg.obs.trace and not cfg.obs.span_dir:
            # Fleet-wide tracing: one shared spans dir; this process
            # journals as "fleet", each worker as "engine-<id>" (the pool
            # hands the workers the same dir).
            cfg.obs.span_dir = os.path.join(cfg.obs.dir, "spans")
            cfg.obs.span_proc = cfg.obs.span_proc or "fleet"
        obs = build_obs(cfg, registry, device=device)
        # The router's own front-end and relay legs frame through the same
        # rung the workers pick from this config.
        proto.set_backend(cfg.fleet.proto_backend)
        pool = EnginePool(cfg, registry=registry, symbol=args.symbol,
                          start=args.start, end=args.end,
                          device=str(device)).start()
        if preempted:
            pool.quiesce()
        router = FleetRouter(pool, cfg.fleet, registry,
                             workdir=cfg.fleet.dir, obs_cfg=cfg.obs,
                             obs=obs).start()
        frontend = ServeFrontend(
            router, registry, host=cfg.fleet.host, port=cfg.fleet.port,
            wire_backend=cfg.fleet.wire_backend,
            tracer=(WireTracer(obs.spans, mint=True)
                    if obs.spans is not None else None)).start()
        if cfg.fleet.autoscale:
            autoscaler = EngineAutoscaler(pool, cfg.fleet,
                                          workdir=cfg.fleet.dir,
                                          registry=registry,
                                          obs=obs).start()
        if learner_cfg is not None:
            service = PriceDataService(config=cfg.data)
            prices = service.request(args.symbol.split(",")[0].strip(),
                                     args.start, args.end).series.prices
            orch = Orchestrator(learner_cfg, device=device)
            if preempted:
                orch.request_preempt()
            orch.send_training_data(prices, resume=args.resume)
            orch.start_training(background=True)
        # Readiness: every engine reported its port (or hit its bring-up
        # budget: say what came up either way).
        deadline = time.monotonic() + cfg.fleet.startup_timeout_s + 10.0
        while (time.monotonic() < deadline and not stop_evt.is_set()
               and len(pool.endpoints()) < cfg.fleet.num_engines):
            stop_evt.wait(0.25)
        router.poll_once()
        print(json.dumps({"event": "fleet_ready",
                          "host": frontend.host, "port": frontend.port,
                          "engines": len(pool.endpoints()),
                          "target_engines": cfg.fleet.num_engines,
                          "dir": cfg.fleet.dir, "device": str(device),
                          "wire_backend": cfg.fleet.wire_backend,
                          "proto_backend": proto.proto_backend,
                          "learner": bool(args.learner),
                          "pid": os.getpid()}), flush=True)
        run_deadline = (time.monotonic() + args.duration
                        if args.duration > 0 else None)
        while not stop_evt.is_set():
            if run_deadline is not None and time.monotonic() >= run_deadline:
                break
            stop_evt.wait(0.25)

        grace = cfg.fleet.drain_grace_s
        if autoscaler is not None:
            autoscaler.stop()   # membership frozen before the drain
        frontend.drain(timeout_s=grace * 0.5)
        frontend.stop()
        router.stop()
        pool.stop(grace_s=grace)
        if orch is not None:
            orch.stop()
        obs.flush()
        counters = registry.counters()
        summary = {
            "requests": int(counters.get("fleet_requests_total", 0)),
            "completed": int(counters.get("fleet_completed_total", 0)),
            "refused": int(counters.get("fleet_refused_total", 0)),
            "unrouted": int(counters.get("fleet_unrouted_total", 0)),
            "migrations": int(counters.get("fleet_migrations_total", 0)),
            "engine_restarts": pool.restarts_total,
            **{f"engines_{k}": v for k, v in pool.counts().items()},
        }
        if autoscaler is not None:
            summary["scale_events"] = pool.scale_events
            summary["autoscale_up"] = int(
                counters.get("fleet_autoscale_up_total", 0))
            summary["autoscale_down"] = int(
                counters.get("fleet_autoscale_down_total", 0))
        if orch is not None:
            snap = orch.snapshot() or {}
            summary["learner_updates"] = snap.get("updates")
            summary["rows_ingested"] = int(orch.metrics.counters().get(
                "distrib_rows_ingested_total", 0))
            summary["learner_restarts"] = orch.restarts
            summary["kernel_launches"] = {**attention.launch_counts,
                                          **fused_update.launch_counts}
        if preempted:
            summary["preempted"] = True
        print(json.dumps(summary), flush=True)
        return EXIT_PREEMPTED if preempted else 0
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if autoscaler is not None:
            autoscaler.stop()
        if frontend is not None:
            frontend.stop()
        if router is not None:
            router.stop()
        if pool is not None:
            pool.stop(grace_s=10.0)
        if orch is not None:
            orch.stop()
        if obs is not None:
            obs.close()
        if service is not None:
            service.close()


def cmd_obs(args) -> int:
    """Summarise a telemetry run directory of either package: the manifest,
    the span aggregates of the Chrome trace, the metrics tail and the
    flight bundle's verdict. ``--trace ID`` (``--trace list``) stitches one
    cross-process trace from the span journals under ``<dir>/spans``
    (``--out`` renders it for Perfetto); ``--history N`` summarises the
    fleet router's last N telemetry rows (``fleet_history.jsonl`` under
    ``--dir``, the fleet's workdir for this flag)."""
    from sharetrade_tpu_torch.obs import summarize_run_dir
    from sharetrade_tpu_torch.utils.logging import get_logger

    log = get_logger("cli")
    if args.trace:
        from sharetrade_tpu_torch.obs import collect
        spans_dir = os.path.join(args.dir, "spans")
        if not os.path.isdir(spans_dir):
            log.error("no span journals under %s (run `cli fleet` with "
                      "obs.enabled=true)", spans_dir)
            return 1
        if args.trace == "list":
            ids = collect.trace_ids(collect.read_span_dir(spans_dir))
            print(json.dumps({"spans_dir": spans_dir, "traces": ids},
                             indent=2))
            return 0
        stitched = collect.collect_trace(spans_dir, args.trace,
                                         out=args.out)
        if not stitched["spans"]:
            log.error("trace %s not found under %s (try --trace list)",
                      args.trace, spans_dir)
            return 1
        view = {"trace_id": stitched["trace_id"],
                "procs": stitched["procs"],
                "errors": stitched["errors"],
                "spans": [{k: s.get(k) for k in
                           ("name", "proc", "span", "parent", "ts_us",
                            "dur_us", "note") if k in s}
                          for s in stitched["spans"]]}
        if "perfetto" in stitched:
            view["perfetto"] = stitched["perfetto"]
        print(json.dumps(view, indent=2))
        return 0 if not stitched["errors"] else 1
    if args.history is not None:
        from sharetrade_tpu_torch.obs.tsdb import (
            FLEET_HISTORY_FILE, read_history, summarize_history)
        path = os.path.join(args.dir, FLEET_HISTORY_FILE)
        rows = read_history(path, last_n=max(0, args.history))
        if not rows:
            log.error("no telemetry history at %s (the fleet router "
                      "writes it next to fleet_status.json)", path)
            return 1
        print(json.dumps({"path": path, **summarize_history(rows)},
                         indent=2))
        return 0
    if not os.path.isdir(args.dir):
        log.error("no run dir at %s (train with --set obs.enabled=true "
                  "--set obs.dir=%s first)", args.dir, args.dir)
        return 1
    summary = summarize_run_dir(args.dir)
    if len(summary) <= 1:   # only {"run_dir": ...}: nothing telemetric
        log.error("%s contains no telemetry artifacts "
                  "(manifest.json/trace.jsonl/metrics.jsonl)", args.dir)
        return 1
    print(json.dumps(summary, indent=2))
    return 0


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
    p.add_argument("--listen", default=None, metavar="HOST:PORT",
                   help="fleet worker mode: serve the fleet wire protocol "
                        "on HOST:PORT instead of synthetic load (port 0: "
                        "ephemeral, named in the engine_listening line; "
                        "--duration 0 serves until SIGTERM)")
    p.set_defaults(fn=cmd_serve)
    p = sub.add_parser("fleet", help="the serving fleet: supervised serve "
                                     "--listen workers behind the router")
    _common(p)
    p.add_argument("--engines", type=int, default=0,
                   help="engine workers (0: fleet.num_engines)")
    p.add_argument("--duration", type=float, default=0.0,
                   help="seconds to run (0: until SIGTERM)")
    p.add_argument("--autoscale", action="store_true",
                   help="drive the pool's size from the router's telemetry "
                        "history (fleet/autoscale.py; sets fleet.autoscale)")
    p.add_argument("--learner", action="store_true",
                   help="run the flywheel's live learner in-process "
                        "(ingest the served sessions' journals under "
                        "distrib.actor_dir, republish tag_best)")
    p.add_argument("--resume", action="store_true",
                   help="the learner resumes the latest checkpoint")
    p.set_defaults(fn=cmd_fleet)
    p = sub.add_parser("actor", help="one rollout actor: epsilon-greedy "
                                     "chunks journaled for a learner")
    _common(p)
    p.add_argument("--actor-id", default=None,
                   help="this actor's id (its directory under "
                        "distrib.actor_dir)")
    p.add_argument("--max-chunks", type=int, default=0,
                   help="stop after this many rollout chunks (0: until "
                        "SIGTERM)")
    p.set_defaults(fn=cmd_actor)
    p = sub.add_parser("learner", help="the DQN learner and its supervised "
                                       "pool of distrib.num_actors actors")
    _common(p)
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest intact checkpoint in "
                        "runtime.checkpoint_dir (or tag_preempt)")
    p.add_argument("--events", default=None, metavar="PATH",
                   help="append the learner's run events as JSON lines "
                        "(each actor_feed_ingest tick with its cursors)")
    p.set_defaults(fn=cmd_learner)
    p = sub.add_parser("query", help="one symbol's price rows through the "
                                     "data service (journaled)")
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--set", action="append", default=[],
                   metavar="SECTION.KEY=VALUE", help="config override")
    p.add_argument("--symbol", default="MSFT")
    p.add_argument("--start", default=None)
    p.add_argument("--end", default=None)
    p.set_defaults(fn=cmd_query)
    p = sub.add_parser("obs", help="summarise a telemetry run directory")
    p.add_argument("--dir", default="obs",
                   help="run dir written with obs.enabled (for --history: "
                        "the fleet workdir holding fleet_history.jsonl)")
    p.add_argument("--trace", default=None, metavar="TRACE_ID",
                   help="stitch one cross-process trace from the span "
                        "journals under <dir>/spans ('list' enumerates "
                        "trace ids)")
    p.add_argument("--out", default=None,
                   help="with --trace: write the stitched trace as "
                        "Perfetto/Chrome trace-event JSON here")
    p.add_argument("--history", type=int, default=None, metavar="N",
                   help="summarise the newest N fleet telemetry-history "
                        "rows (0 = all retained)")
    p.set_defaults(fn=cmd_obs)
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
