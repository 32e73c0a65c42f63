"""The port's fleet router against the JAX package's, on the LSTM.

An LSTM's carry makes affinity and migration visible: a warm answer differs
from a cold one, so a session that moved engines shows it. The same
scripted sessions (six sessions, four rounds, one request in flight at a
time) go through a router over two engines, and the first engine is
stopped at a fixed request (after round two). Telemetry is held fixed: one
``poll_once`` by hand on the idle engines, no poller thread. Four pairings
run the script — port router over port engines, JAX router over JAX
engines (the reference), JAX router over port engines, port router over
JAX engines — and each must match the reference: the engine every request
was served by, ``fleet_migrations_total``, and every answer's logits and
value within ``ATOL`` (fp32). With both engines gone the router answers
503 and counts the request unrouted.

The fleet quantiles: the port router's ``fleet_p50_ms`` / ``fleet_p99_ms``,
from bucket-wise merged scrapes of two port engines, fall within one bucket
of the nearest-rank percentiles of the concatenated engine-side latencies.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sharetrade_tpu import fleet as jfleet
from sharetrade_tpu.config import FleetConfig as JFleetConfig
from sharetrade_tpu.config import ModelConfig as JModelConfig
from sharetrade_tpu.config import ServeConfig as JServeConfig
from sharetrade_tpu.models import build_model as jbuild_model
from sharetrade_tpu.serve import ServeEngine as JServeEngine
from sharetrade_tpu.utils.metrics import MetricsRegistry as JRegistry
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch import fleet as tfleet
from sharetrade_tpu_torch.config import FleetConfig, ModelConfig, ServeConfig
from sharetrade_tpu_torch.models import build_model
from sharetrade_tpu_torch.serve import ServeEngine
from sharetrade_tpu_torch.serve.engine import latency_percentiles
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

WINDOW = 8
OBS_DIM = WINDOW + 2
ATOL = 1e-5
SESSIONS, ROUNDS, STOP_AFTER_ROUND = 6, 4, 2
SERVE = dict(max_batch=4, slots=8, batch_timeout_ms=1.0)


def _obs(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(1.0, 2.0,
                                               OBS_DIM).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild_model(JModelConfig(kind="lstm", hidden_dim=8), OBS_DIM,
                          head="ac")
    jparams = jmodel.init(jax.random.PRNGKey(1))
    tmodel = build_model(ModelConfig(kind="lstm", hidden_dim=8), OBS_DIM,
                         device="cpu")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return {"jax": (jmodel, jparams), "port": (tmodel, tparams)}


def _engines(models, pkg: str):
    """Two warmed engines of ``pkg``, each behind its own front-end."""
    out = []
    for _ in range(2):
        if pkg == "jax":
            model, params = models["jax"]
            reg = JRegistry()
            engine = JServeEngine(model, JServeConfig(**SERVE), params,
                                  params_step=1, registry=reg)
            engine.warmup()
            fe = jfleet.ServeFrontend(jfleet.EngineBackend(engine),
                                      reg).start()
        else:
            model, params = models["port"]
            reg = MetricsRegistry()
            engine = ServeEngine(model, ServeConfig(**SERVE), params,
                                 params_step=1, registry=reg)
            engine.warmup()
            fe = tfleet.ServeFrontend(tfleet.EngineBackend(engine),
                                      reg).start()
        out.append((engine, fe))
    return out


def _run(models, router_pkg: str, engine_pkg: str) -> dict:
    fleet = jfleet if router_pkg == "jax" else tfleet
    cfg = JFleetConfig() if router_pkg == "jax" else FleetConfig()
    registry = JRegistry() if router_pkg == "jax" else MetricsRegistry()
    engines = _engines(models, engine_pkg)
    router = fleet.FleetRouter(
        fleet.StaticEndpoints({f"e{i}": (fe.host, fe.port)
                               for i, (_, fe) in enumerate(engines)}),
        cfg, registry, workdir="")
    rfe = fleet.ServeFrontend(router, registry).start()
    client = fleet.FleetClient(rfe.host, rfe.port)
    choices, answers = [], []
    try:
        router.poll_once()          # telemetry held fixed from here on
        for rnd in range(ROUNDS):
            if rnd == STOP_AFTER_ROUND:
                engine, fe = engines[0]
                fe.stop()
                engine.stop(drain=False)
            for s in range(SESSIONS):
                reply = client.submit(f"s{s}", _obs(100 * s + rnd))
                choices.append(reply["engine"])
                answers.append((np.asarray(reply["logits"], np.float32),
                                float(reply["value"])))
        engine, fe = engines[1]
        fe.stop()
        engine.stop(drain=False)
        status, _ = client.raw_request(
            "/v1/submit", b'{"session": "s0", "obs": [1.0, 2.0, 3.0]}')
        counters = registry.counters()
        return {"choices": choices, "answers": answers,
                "migrations": counters.get("fleet_migrations_total", 0),
                "unrouted": counters.get("fleet_unrouted_total", 0),
                "final_status": status}
    finally:
        client.close()
        rfe.stop()
        router.stop()
        for engine, fe in engines:
            fe.stop()
            engine.stop(drain=False)


@pytest.fixture(scope="module")
def reference(models):
    return _run(models, "jax", "jax")


def test_reference_script_migrates(reference):
    """The script is non-trivial: both engines serve, the stopped engine's
    sessions move, and the JAX router's outcome is what the pairings are
    held to."""
    first = reference["choices"][:SESSIONS * STOP_AFTER_ROUND]
    after = reference["choices"][SESSIONS * STOP_AFTER_ROUND:]
    assert set(first) == {"e0", "e1"}
    assert set(after) == {"e1"}
    assert reference["migrations"] == 1
    assert reference["final_status"] == 503 and reference["unrouted"] >= 1


@pytest.mark.parametrize("router_pkg,engine_pkg", [
    ("port", "port"), ("jax", "port"), ("port", "jax")])
def test_routing_migration_and_answers_match_the_jax_router(
        models, reference, router_pkg, engine_pkg):
    got = _run(models, router_pkg, engine_pkg)
    assert got["choices"] == reference["choices"]
    assert got["migrations"] == reference["migrations"]
    assert got["final_status"] == 503 and got["unrouted"] >= 1
    for i, ((logits, value), (ref_logits, ref_value)) in enumerate(
            zip(got["answers"], reference["answers"])):
        np.testing.assert_allclose(logits, ref_logits, atol=ATOL, rtol=0,
                                   err_msg=f"request {i}")
        assert abs(value - ref_value) <= ATOL, i


def test_warm_carry_is_visible_and_migration_restarts_cold(models,
                                                           reference):
    """A session's second answer differs from a cold first step on the
    same observation (the carry is real), and a migrated session's answer
    equals a cold first step: the migration claim is not vacuous."""
    model, params = models["port"]
    with torch.inference_mode():
        cold = []
        for s in range(SESSIONS):
            for rnd in (1, STOP_AFTER_ROUND):
                h, c = model.init_carry()
                out, _ = model.apply_batch(
                    params, torch.from_numpy(_obs(100 * s + rnd))[None],
                    (h[None], c[None]))
                cold.append(((s, rnd), out.logits[0].numpy()))
    cold = dict(cold)
    warm_idx = SESSIONS * 1          # round 1, session 0
    assert np.abs(reference["answers"][warm_idx][0]
                  - cold[(0, 1)]).max() > 1e-3
    moved = [s for s in range(SESSIONS)
             if reference["choices"][s] == "e0"]
    assert moved
    for s in moved:
        idx = SESSIONS * STOP_AFTER_ROUND + s
        np.testing.assert_allclose(reference["answers"][idx][0],
                                   cold[(s, STOP_AFTER_ROUND)], atol=ATOL,
                                   rtol=0)


def test_fleet_quantiles_within_one_bucket_of_the_samples(models):
    engines = _engines(models, "port")
    registry = MetricsRegistry()
    router = tfleet.FleetRouter(
        tfleet.StaticEndpoints({f"e{i}": (fe.host, fe.port)
                                for i, (_, fe) in enumerate(engines)}),
        FleetConfig(), registry, workdir="")
    try:
        router.poll_once()
        samples = []
        for i in range(40):
            reply = router.serve_request(f"q{i % 10}", _obs(i), None)
            samples.append(reply["latency_ms"])
        router.poll_once()
        fleet_hist = registry.histogram("fleet_request_ms")
        assert fleet_hist.count == len(samples)
        exact = latency_percentiles(samples)
        bounds = fleet_hist.bounds
        for key, gauge in (("p50_ms", "fleet_p50_ms"),
                           ("p99_ms", "fleet_p99_ms")):
            est = registry.latest(gauge)
            idx = int(np.searchsorted(bounds, exact[key]))
            lo = bounds[idx - 1] if idx > 0 else 0.0
            hi = bounds[idx] if idx < len(bounds) else bounds[-1]
            assert abs(est - exact[key]) <= (hi - lo) + 1e-9, (key, est,
                                                              exact[key])
    finally:
        router.stop()
        for engine, fe in engines:
            fe.stop()
            engine.stop(drain=False)
