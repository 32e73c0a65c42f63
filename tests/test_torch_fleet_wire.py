"""The port's fleet front-ends on the wire, against the JAX package's.

- The port's evloop and threaded front-ends, in front of one port engine
  (q_mlp, the JAX init converted), answer one scripted request stream —
  health, submits, malformed bodies and headers, unknown paths, a
  pipelined burst — with byte-identical response streams, whole and torn
  into 7-byte chunks. The engine's timing fields are pinned to 0 for this
  comparison (they are wall-clock); every other byte is the engine's.
- A JAX ``FleetClient`` against the port's front-end and the port's client
  against a JAX front-end (a JAX engine on the same weights) answer within
  ``ATOL`` of each other. The JAX engine is not bitwise equal to a
  sequential ``model.apply`` on this tree (ROADMAP C4), so the bar is
  tolerance; fp32 survives the wire's JSON exactly.
- A request whose deadline expires at the port engine's collection gate is
  a 504 (the engine's ``serve_deadline_expired_total`` moves); a malformed
  request is a 400.
- The port's ``/metrics``, parsed by the JAX ``parse_prom_text``, rebuilds
  a histogram that merges with a JAX engine's bucket for bucket, and the
  reverse.
- An idle engine's ``/healthz`` republishes ``serve_spill_bytes`` /
  ``serve_spill_sessions`` after another engine pages out into the shared
  arena (``ServeEngine.refresh_spill_gauges``).

Tolerance: logits and values ``ATOL 1e-5`` (fp32).
"""

from __future__ import annotations

import json
import socket
import time

import jax
import numpy as np
import pytest
import torch

from sharetrade_tpu.config import ModelConfig as JModelConfig
from sharetrade_tpu.config import ServeConfig as JServeConfig
from sharetrade_tpu.fleet import EngineBackend as JEngineBackend
from sharetrade_tpu.fleet import FleetClient as JFleetClient
from sharetrade_tpu.fleet import ServeFrontend as JServeFrontend
from sharetrade_tpu.models import build_model as jbuild_model
from sharetrade_tpu.obs import exporter as jexporter
from sharetrade_tpu.obs import hist as jhist
from sharetrade_tpu.serve import ServeEngine as JServeEngine
from sharetrade_tpu.utils.metrics import MetricsRegistry as JRegistry
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.config import ModelConfig, ServeConfig
from sharetrade_tpu_torch.fleet import (
    EngineBackend, FleetClient, ServeFrontend, proto, wire)
from sharetrade_tpu_torch.models import build_model
from sharetrade_tpu_torch.models.core import tree_leaves
from sharetrade_tpu_torch.obs import exporter, hist
from sharetrade_tpu_torch.serve import ServeEngine
from sharetrade_tpu_torch.serve.engine import ServeDeadlineExceeded
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

WINDOW = 8
OBS_DIM = WINDOW + 2
ATOL = 1e-5


def _obs(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(1.0, 2.0,
                                               OBS_DIM).astype(np.float32)


@pytest.fixture(scope="module")
def jax_q():
    model = jbuild_model(JModelConfig(kind="mlp", hidden_dim=16), OBS_DIM,
                         head="q")
    return model, model.init(jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_q(jax_q):
    model = build_model(ModelConfig(kind="mlp", hidden_dim=16), OBS_DIM,
                        head="q", device="cpu")
    return model, convert.params_from_jax(jax.tree.map(np.asarray,
                                                       jax_q[1]))


def _port_engine(port_q, registry=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("slots", 8)
    kw.setdefault("batch_timeout_ms", 1.0)
    engine = ServeEngine(port_q[0], ServeConfig(**kw), port_q[1],
                         params_step=11,
                         registry=registry or MetricsRegistry())
    engine.warmup()
    return engine


@pytest.fixture(scope="module")
def port_engine(port_q):
    engine = _port_engine(port_q)
    yield engine
    engine.stop(drain=False)


@pytest.fixture(scope="module")
def jax_engine(jax_q):
    registry = JRegistry()
    engine = JServeEngine(jax_q[0], JServeConfig(max_batch=4, slots=8,
                                                 batch_timeout_ms=1.0),
                          jax_q[1], params_step=11, registry=registry)
    engine.warmup()
    yield engine
    engine.stop(drain=False)


class _Pinned(EngineBackend):
    """The port engine with its wall-clock fields pinned, so two front-ends'
    reply bytes are comparable."""

    @staticmethod
    def result_dict(result) -> dict:
        out = EngineBackend.result_dict(result)
        out["latency_ms"] = 0.0
        out["stages"] = {}
        return out


def _scripted_stream() -> tuple[bytes, int]:
    def submit(session, obs, **headers):
        body = json.dumps({"session": session,
                           "obs": [float(x) for x in obs]}).encode()
        return proto.render_request("POST", wire.SUBMIT_PATH, "h:1", body,
                                    headers=headers or None)

    reqs = [
        proto.render_request("GET", wire.HEALTH_PATH, "h:1"),
        submit("d-1", _obs(1)),
        proto.render_request("POST", wire.SUBMIT_PATH, "h:1", b"not json"),
        proto.render_request("POST", wire.SUBMIT_PATH, "h:1",
                             b'{"obs": [1.0]}'),
        submit("d-2", _obs(2), **{wire.DEADLINE_HEADER: "soon"}),
        submit("d-3", _obs(3), **{wire.CLOCK_HEADER: "x"}),
        submit("d-4", [float("nan")] * OBS_DIM),
        submit("d-5", [1.0, 2.0]),
        proto.render_request("GET", "/nope", "h:1"),
        proto.render_request("POST", "/nope", "h:1", b"ignored body"),
        submit("d-6", _obs(6)) + submit("d-7", _obs(7))
        + submit("d-1", _obs(8)),
    ]
    return b"".join(reqs), 13


def _drive(host: str, port: int, payload: bytes, n: int,
           chunk: int | None = None) -> bytes:
    sock = socket.create_connection((host, port), timeout=30.0)
    sock.settimeout(30.0)
    step = chunk or len(payload)
    for i in range(0, len(payload), step):
        sock.sendall(payload[i:i + step])
    parser = proto.ResponseParser()
    raw = bytearray()
    got = 0
    while got < n:
        data = sock.recv(1 << 16)
        if not data:
            break
        raw += data
        got += len(parser.feed(data))
    sock.close()
    assert got == n
    return bytes(raw)


def test_evloop_and_threaded_answer_byte_identically(port_engine):
    payload, n = _scripted_stream()
    streams = {}
    for backend in ("threaded", "evloop"):
        fe = ServeFrontend(_Pinned(port_engine), port_engine.registry,
                           wire_backend=backend).start()
        try:
            streams[backend] = _drive(fe.host, fe.port, payload, n)
            assert _drive(fe.host, fe.port, payload, n, chunk=7) == \
                streams[backend]
        finally:
            fe.stop()
    assert streams["threaded"] == streams["evloop"]
    replies = proto.ResponseParser().feed(streams["evloop"])
    assert [r.status for r in replies] == [200, 200, 400, 400, 400, 400,
                                           400, 400, 404, 404, 200, 200,
                                           200]
    assert json.loads(replies[1].body)["params_step"] == 11


@pytest.mark.parametrize("backend", ["evloop", "threaded"])
def test_cross_package_clients_agree(port_engine, jax_engine, backend):
    port_fe = ServeFrontend(EngineBackend(port_engine), port_engine.registry,
                            wire_backend=backend).start()
    jax_fe = JServeFrontend(JEngineBackend(jax_engine), jax_engine.registry,
                            wire_backend=backend).start()
    jax_client = JFleetClient(port_fe.host, port_fe.port)
    port_client = FleetClient(jax_fe.host, jax_fe.port)
    try:
        for i in range(6):
            obs = _obs(100 + i)
            via_port = jax_client.submit(f"x{i}", obs)
            via_jax = port_client.submit(f"x{i}", obs)
            np.testing.assert_allclose(via_port["logits"],
                                       via_jax["logits"], atol=ATOL, rtol=0)
            assert abs(via_port["value"] - via_jax["value"]) <= ATOL
            assert via_port["params_step"] == via_jax["params_step"] == 11
            assert set(via_port) == set(via_jax)
        assert set(jax_client.health()) == set(port_client.health())
    finally:
        jax_client.close()
        port_client.close()
        port_fe.stop()
        jax_fe.stop()


def test_deadline_expires_engine_side_as_504(port_q):
    registry = MetricsRegistry()
    engine = _port_engine(port_q, registry, batch_timeout_ms=250.0)
    fe = ServeFrontend(EngineBackend(engine), registry).start()
    first = FleetClient(fe.host, fe.port)
    late = FleetClient(fe.host, fe.port)
    try:
        # The first request of s-dl is collected and coalesces for the
        # whole 250 ms window; its same-session follower (50 ms deadline)
        # waits deferred past its deadline and expires at the next
        # collection: the engine's gate, not a front-end timer.
        import threading
        done = []
        t = threading.Thread(target=lambda: done.append(
            first.submit("s-dl", _obs(1))))
        t.start()
        time.sleep(0.02)
        before = registry.counters().get("serve_deadline_expired_total", 0)
        status, body = late.raw_request(
            wire.SUBMIT_PATH,
            json.dumps({"session": "s-dl",
                        "obs": [float(x) for x in _obs(2)]}).encode(),
            extra_headers={wire.DEADLINE_HEADER: "50"})
        assert status == wire.STATUS_DEADLINE == 504
        assert isinstance(wire.status_to_error(status, json.loads(body)),
                          ServeDeadlineExceeded)
        assert registry.counters().get("serve_deadline_expired_total",
                                       0) == before + 1
        t.join(10.0)
        assert done and done[0]["session"] == "s-dl"
    finally:
        first.close()
        late.close()
        fe.stop()
        engine.stop(drain=False)


@pytest.mark.parametrize("body", [b"not json", b'{"obs": [1.0]}',
                                  b'{"session": "m", "obs": [1.0, 2.0]}'])
def test_malformed_request_is_400(port_engine, body):
    fe = ServeFrontend(EngineBackend(port_engine),
                       port_engine.registry).start()
    client = FleetClient(fe.host, fe.port)
    try:
        status, reply = client.raw_request(wire.SUBMIT_PATH, body)
        assert status == wire.STATUS_BAD_REQUEST == 400
        assert json.loads(reply)["error"] == "bad_request"
        with pytest.raises(ValueError):
            client.submit("m2", [float("nan")] * OBS_DIM)
    finally:
        client.close()
        fe.stop()


def _rebuilt(text: str, parse, from_buckets):
    h = parse(text)["histograms"]["sharetrade_serve_request_ms"]
    return from_buckets(h["buckets"], h["sum"], int(h["count"]))


def test_metrics_merge_exactly_across_packages(port_engine, jax_engine):
    port_fe = ServeFrontend(EngineBackend(port_engine),
                            port_engine.registry).start()
    jax_fe = JServeFrontend(JEngineBackend(jax_engine),
                            jax_engine.registry).start()
    jax_client = JFleetClient(port_fe.host, port_fe.port)
    port_client = FleetClient(jax_fe.host, jax_fe.port)
    try:
        for i in range(5):
            jax_client.submit(f"m{i}", _obs(200 + i))
            port_client.submit(f"m{i}", _obs(300 + i))
        port_text, jax_text = jax_client.metrics(), port_client.metrics()
        # Each package's strict reader accepts the other's exposition.
        port_h = _rebuilt(port_text, jexporter.parse_prom_text,
                          jhist.from_prom_buckets)
        jax_h = _rebuilt(jax_text, jexporter.parse_prom_text,
                         jhist.from_prom_buckets)
        assert port_h.bounds == jax_h.bounds
        merged = jhist.merge([port_h, jax_h])
        assert merged.counts == [a + b for a, b in zip(port_h.counts,
                                                       jax_h.counts)]
        assert merged.count == port_h.count + jax_h.count >= 10
        # The port's reader and merge give the same histogram.
        port_side = hist.merge([
            _rebuilt(port_text, exporter.parse_prom_text,
                     hist.from_prom_buckets),
            _rebuilt(jax_text, exporter.parse_prom_text,
                     hist.from_prom_buckets)])
        assert port_side.counts == merged.counts
        assert port_side.bounds == merged.bounds
        assert port_side.quantile(0.99) == merged.quantile(0.99)
        # The renderers agree on the same snapshot byte for byte.
        snap = port_engine.registry
        assert exporter.render_prom_text(
            snap.snapshot(), snap.counters(), snap.histograms()) == \
            jexporter.render_prom_text(snap.snapshot(), snap.counters(),
                                       snap.histograms())
    finally:
        jax_client.close()
        port_client.close()
        port_fe.stop()
        jax_fe.stop()


def test_idle_engine_healthz_republishes_spill_gauges(tmp_path):
    model = build_model(ModelConfig(kind="lstm", hidden_dim=8), OBS_DIM,
                        device="cpu")
    params = model.init(torch.Generator().manual_seed(1))
    nbytes = sum(x.numel() * x.element_size()
                 for x in tree_leaves(model.init_carry()))

    def engine(registry):
        e = ServeEngine(model, ServeConfig(
            max_batch=2, slots=4, batch_timeout_ms=1.0,
            stats_interval_s=0.05, warm_bytes=nbytes,
            spill_dir=str(tmp_path), spill_bytes=1 << 24), params,
            registry=registry)
        e.warmup()
        return e

    idle_reg = MetricsRegistry()
    idle = engine(idle_reg)
    fe = ServeFrontend(EngineBackend(idle), idle_reg).start()
    client = FleetClient(fe.host, fe.port)
    busy = engine(MetricsRegistry())
    try:
        client.health()
        assert idle_reg.latest("serve_spill_sessions", 0.0) == 0.0
        for i in range(3):
            assert busy.submit(f"p{i}", _obs(i)).wait(30.0) is not None
        assert busy.stop(timeout_s=30.0)
        assert busy.page_out_all()["written"] == 3
        time.sleep(0.06)        # past the idle engine's stats interval
        client.health()
        gauges = exporter.parse_prom_text(client.metrics())["gauges"]
        assert gauges["sharetrade_serve_spill_sessions"] == 3.0
        assert gauges["sharetrade_serve_spill_bytes"] > 0
    finally:
        client.close()
        fe.stop()
        idle.stop(drain=False)
        busy.stop(drain=False)
