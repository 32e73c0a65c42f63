"""The port's serve engine with an enabled ``obs`` facade, on a small MLP on
the CPU, held against the JAX engine's request traces (the contracts of
``tests/test_serve_trace.py``):

- every terminal outcome (completed, expired, rejected behind a stalled
  consumer) leaves one ``serve_request`` span naming it, and a completed
  request's stage children sum to its envelope; the same script through
  the JAX engine gives spans with the same names, categories and argument
  keys;
- the stage decomposition is exact and the error counter stays 0;
- the exemplar ring is bounded and sorted, and written to
  ``serve_exemplars.json``;
- a restart storm past ``serve.max_restarts`` dumps a ``serve_failed``
  bundle with its ``serve_restart`` trail; an availability burn records
  one ``slo_burn`` flight event and a trace instant;
- each package's ``summarize_run_dir`` reads the port's run directory to
  the same sections;
- obs off leaves no file.
"""

from __future__ import annotations

import json
import os
import threading
import time

import jax
import numpy as np
import pytest

from sharetrade_tpu.config import FrameworkConfig as JConfig
from sharetrade_tpu.config import ModelConfig as JModelConfig
from sharetrade_tpu.config import ServeConfig as JServeConfig
from sharetrade_tpu.models import build_model as jbuild_model
from sharetrade_tpu.obs import build_obs as jbuild_obs
from sharetrade_tpu.obs import read_trace
from sharetrade_tpu.obs import summarize_run_dir as jsummarize
from sharetrade_tpu.serve import ServeEngine as JServeEngine
from sharetrade_tpu.utils.metrics import MetricsRegistry as JRegistry
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.config import (
    FrameworkConfig,
    ModelConfig,
    ServeConfig,
)
from sharetrade_tpu_torch.models import build_model
from sharetrade_tpu_torch.obs import build_obs, summarize_run_dir
from sharetrade_tpu_torch.serve import ServeEngine
from sharetrade_tpu_torch.serve.engine import ServeDeadlineExceeded
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

OBS_DIM = 10
OUTCOME_SERVE = dict(max_batch=2, slots=4, batch_timeout_ms=1.0,
                     swap_poll_s=0.0, stats_interval_s=0.1, max_queue=2,
                     shed_policy="reject")


@pytest.fixture(scope="module")
def bundles():
    jmodel = jbuild_model(JModelConfig(kind="mlp", hidden_dim=8), OBS_DIM,
                          head="ac")
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tmodel = build_model(ModelConfig(kind="mlp", hidden_dim=8), OBS_DIM,
                         device="cpu")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return {"jax": (jmodel, jparams), "torch": (tmodel, tparams)}


def obs_for(i: float = 10.0) -> np.ndarray:
    return np.full((OBS_DIM,), i, np.float32)


def build_engine(pkg, tmp_path, bundles, *, serve=None, **obs_overrides):
    cfg = JConfig() if pkg == "jax" else FrameworkConfig()
    cfg.obs.enabled = True
    cfg.obs.dir = str(tmp_path / f"obs-{pkg}")
    cfg.obs.export_interval_s = 60.0
    for key, value in obs_overrides.items():
        setattr(cfg.obs, key, value)
    serve_cls = JServeConfig if pkg == "jax" else ServeConfig
    cfg.serve = serve_cls(**(serve or dict(
        max_batch=4, slots=8, batch_timeout_ms=1.0, swap_poll_s=0.0,
        stats_interval_s=0.1)))
    model, params = bundles[pkg]
    if pkg == "jax":
        registry = JRegistry()
        obs = jbuild_obs(cfg, registry)
        engine = JServeEngine(model, cfg.serve, params, registry=registry,
                              obs=obs, obs_cfg=cfg.obs)
    else:
        registry = MetricsRegistry()
        obs = build_obs(cfg, registry, device="cpu")
        engine = ServeEngine(model, cfg.serve, params, registry=registry,
                             obs=obs, obs_cfg=cfg.obs)
    engine.warmup()
    return engine, registry, obs, cfg


def _outcome_script(pkg, tmp_path, bundles):
    """Completions, one expiry, then rejections behind a stalled consumer;
    returns the trace events and the count of rejections."""
    engine, registry, obs, cfg = build_engine(pkg, tmp_path, bundles,
                                              serve=OUTCOME_SERVE)
    for i in range(6):
        assert engine.submit(f"ok{i}", obs_for()).wait(30.0) is not None
    expired = engine.submit("late", obs_for(), deadline_ms=-1.0)
    assert expired.wait(30.0) is None
    assert type(expired.error).__name__ == "ServeDeadlineExceeded"
    engaged = threading.Event()

    def stall(_r):
        engaged.set()
        time.sleep(0.25)

    stalled = engine.submit("stall", obs_for(), callback=stall)
    assert engaged.wait(20.0)
    flood = [engine.submit(f"f{i}", obs_for()) for i in range(40)]
    rejected = 0
    for h in flood:
        h.wait(30.0)
        rejected += type(h.error).__name__ == "ServeRejected"
    assert rejected > 0
    assert stalled.wait(20.0) is not None
    engine.stop()
    obs.flush()
    obs.close()
    events = read_trace(os.path.join(cfg.obs.dir, "trace.jsonl"))
    return events, rejected, 6 + 1 + 1 + len(flood)


@pytest.fixture(scope="module")
def outcome_runs(bundles, tmp_path_factory):
    root = tmp_path_factory.mktemp("serve-outcomes")
    return {pkg: _outcome_script(pkg, root, bundles)
            for pkg in ("jax", "torch")}


def _shape(events):
    """Names, categories and argument keys of the request spans."""
    return {(e["name"], e.get("cat"), e["ph"], tuple(sorted(e["args"])))
            for e in events if "request" in e.get("args", {})}


def test_every_terminal_outcome_traced(outcome_runs):
    events, rejected, total = outcome_runs["torch"]
    spans = [e for e in events if e["name"] == "serve_request"]
    assert len(spans) == total
    outcomes = [e["args"]["outcome"] for e in spans]
    assert outcomes.count("expired") == 1
    assert outcomes.count("queue_full") == rejected
    assert outcomes.count("completed") == total - 1 - rejected
    by_req: dict = {}
    for e in events:
        if e.get("ph") == "X" and "request" in e.get("args", {}):
            by_req.setdefault(e["args"]["request"], {})[e["name"]] = e
    for e in spans:
        if e["args"]["outcome"] != "completed":
            continue
        group = by_req[e["args"]["request"]]
        assert {"serve_request", "queue_wait", "batch_wait", "device",
                "readback"} <= set(group)
        stage_sum = sum(group[n]["dur"] for n in
                        ("queue_wait", "batch_wait", "device", "readback"))
        assert stage_sum == pytest.approx(group["serve_request"]["dur"],
                                          abs=1.0)     # µs
        assert group["serve_request"]["args"]["batch"] >= 1
        env = group["serve_request"]
        for name in ("queue_wait", "batch_wait", "device", "readback"):
            child = group[name]
            assert child["tid"] == env["tid"]
            assert env["ts"] - 0.01 <= child["ts"]
            assert child["ts"] + child["dur"] <= env["ts"] + env["dur"] + 0.01


def test_request_spans_have_the_jax_shape(outcome_runs):
    assert _shape(outcome_runs["torch"][0]) == _shape(outcome_runs["jax"][0])


def test_stage_decomposition_exact_and_counter_zero(tmp_path, bundles):
    engine, registry, obs, cfg = build_engine("torch", tmp_path, bundles)
    for i in range(30):
        r = engine.submit(f"s{i % 5}", obs_for()).wait(30.0)
        assert sum(r.stages.values()) == pytest.approx(r.latency_ms,
                                                       abs=1e-6)
    time.sleep(0.15)
    assert engine.submit("last", obs_for()).wait(30.0) is not None
    engine.stop()
    obs.close()
    assert registry.counters().get(
        "serve_trace_decomposition_error_total", 0) == 0
    assert registry.histogram("serve_request_ms").count == 31
    sections = {frozenset(reader(cfg.obs.dir))
                for reader in (summarize_run_dir, jsummarize)}
    assert len(sections) == 1
    serve = summarize_run_dir(cfg.obs.dir)["serve"]
    assert serve == jsummarize(cfg.obs.dir)["serve"]
    assert serve["trace_decomposition_errors_total"] == 0
    assert serve["stages"]["device"]["count"] == 31
    assert serve["slowest_exemplars"][0]["latency_ms"] > 0


def test_exemplar_ring_bounded_sorted_and_written(tmp_path, bundles):
    engine, registry, obs, cfg = build_engine("torch", tmp_path, bundles,
                                              exemplar_k=2)
    for i in range(40):
        assert engine.submit(f"e{i % 6}", obs_for()).wait(30.0)
        if i == 20:
            time.sleep(0.12)        # a second stats window
    engine.stop()
    obs.close()
    ex = engine.exemplars()
    assert 0 < len(ex) <= 4 * 2 + 2
    lats = [e["latency_ms"] for e in ex]
    assert lats == sorted(lats, reverse=True)
    assert all({"queue_wait_ms", "batch_wait_ms", "device_ms"}
               <= set(e["stages"]) for e in ex)
    with open(os.path.join(cfg.obs.dir, "serve_exemplars.json")) as f:
        assert json.load(f)["exemplars"][0]["latency_ms"] == lats[0]


def test_failure_and_burn_flight_events(tmp_path, bundles):
    serve = dict(max_batch=2, slots=4, batch_timeout_ms=1.0,
                 swap_poll_s=0.0, stats_interval_s=0.05, max_restarts=1,
                 restart_backoff_s=0.01, restart_backoff_max_s=0.02)
    engine, registry, obs, cfg = build_engine(
        "torch", tmp_path, bundles, serve=serve, slo_availability=0.9,
        slo_window_s=60.0, slo_burn_threshold=2.0)
    assert engine.submit("warm", obs_for()).wait(30.0) is not None
    late = [engine.submit(f"b{i}", obs_for(), deadline_ms=-1.0)
            for i in range(5)]
    for h in late:
        h.wait(30.0)
        assert isinstance(h.error, ServeDeadlineExceeded)
    time.sleep(0.1)
    assert engine.submit("tick", obs_for()).wait(30.0) is not None
    for i in range(2):                  # two malformed-obs faults
        bad = engine.submit(f"bad{i}", np.ones(3, np.float32))
        bad.wait(30.0)
        assert bad.error is not None
    deadline = time.monotonic() + 30
    while engine.failed is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert engine.failed is not None
    engine.stop(drain=False)
    obs.close()
    with open(os.path.join(cfg.obs.dir, "flight_recorder.json")) as f:
        bundle = json.load(f)
    assert bundle["reason"] == "serve_failed"
    kinds = [e["kind"] for e in bundle["events"]]
    restarts = [e for e in bundle["events"] if e["kind"] == "serve_restart"]
    assert len(restarts) == 1 and restarts[0]["streak"] == 1
    assert kinds.count("slo_burn") == 1 and "serve_exemplars" in kinds
    events = read_trace(os.path.join(cfg.obs.dir, "trace.jsonl"))
    names = [e["name"] for e in events if e["ph"] == "i"]
    assert "serve_slo_burn" in names and "flight_recorder_dump" in names
    with pytest.raises(Exception):
        engine.submit("after", obs_for())


def test_obs_off_writes_nothing(tmp_path, bundles, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model, params = bundles["torch"]
    cfg = FrameworkConfig()
    registry = MetricsRegistry()
    obs = build_obs(cfg, registry, device="cpu")
    assert not obs.enabled and obs.spans is None
    engine = ServeEngine(model, ServeConfig(
        max_batch=2, slots=4, batch_timeout_ms=1.0, swap_poll_s=0.0,
        stats_interval_s=0.05), params, registry=registry, obs=obs,
        obs_cfg=cfg.obs)
    engine.warmup()
    r = engine.submit("a", obs_for()).wait(30.0)
    assert r is not None and r.stages is not None
    engine.stop()
    obs.close()
    assert engine._req_tracer is None
    assert list(tmp_path.iterdir()) == []
