"""Fleet tracing across the two packages, in-process on loopback.

A JAX router fronts a port engine, and a port router fronts a JAX engine.
Each process role journals through its own package's span sink into one
shared ``spans/`` directory (``obs.span_dir``): a traced client
(``client_submit``), the router's front-end hop (``frontend``) and its
event-loop relay (``relay``, ``relay_attempt``), and the engine's
``engine_recv`` instant and ``engine_request`` span with its stage
children, parented under the router's attempt span from the wire headers.
Both packages' collectors read each directory to the same spans, and every
trace stitches across the client, the router and the engine with no
error. ``cli obs --trace list`` and ``--trace <id> --out`` of the port read
the same directory.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest

from sharetrade_tpu import fleet as jfleet
from sharetrade_tpu.config import FleetConfig as JFleetConfig
from sharetrade_tpu.config import ModelConfig as JModelConfig
from sharetrade_tpu.config import ServeConfig as JServeConfig
from sharetrade_tpu.fleet.wire import WireTracer as JWireTracer
from sharetrade_tpu.models import build_model as jbuild_model
from sharetrade_tpu.obs import Obs as JObs
from sharetrade_tpu.obs import collect as jcollect
from sharetrade_tpu.obs.trace import SpanJournal as JSpanJournal
from sharetrade_tpu.obs.trace import SpanSink as JSpanSink
from sharetrade_tpu.serve import ServeEngine as JServeEngine
from sharetrade_tpu.utils.metrics import MetricsRegistry as JRegistry
from sharetrade_tpu_torch import cli, convert
from sharetrade_tpu_torch import fleet as tfleet
from sharetrade_tpu_torch.config import FleetConfig, ModelConfig, ServeConfig
from sharetrade_tpu_torch.fleet.wire import WireTracer
from sharetrade_tpu_torch.models import build_model
from sharetrade_tpu_torch.obs import Obs
from sharetrade_tpu_torch.obs import collect as tcollect
from sharetrade_tpu_torch.obs.trace import SpanJournal, SpanSink
from sharetrade_tpu_torch.serve import ServeEngine
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

OBS_DIM = 10
SERVE = dict(max_batch=4, slots=8, batch_timeout_ms=1.0)
SESSIONS, ROUNDS = 6, 2


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild_model(JModelConfig(kind="mlp", hidden_dim=8), OBS_DIM,
                          head="ac")
    jparams = jmodel.init(jax.random.PRNGKey(2))
    tmodel = build_model(ModelConfig(kind="mlp", hidden_dim=8), OBS_DIM,
                         device="cpu")
    tparams = convert.params_from_jax(jax.tree.map(np.asarray, jparams))
    return {"jax": (jmodel, jparams), "torch": (tmodel, tparams)}


def _sink(pkg: str, spans_dir: str, proc: str):
    """``proc``'s sink. Span ids are unique per process (pid-prefixed); the
    roles share one process here, so each gets its own prefix."""
    sink = (JSpanSink(JSpanJournal(spans_dir, proc)) if pkg == "jax"
            else SpanSink(SpanJournal(spans_dir, proc)))
    sink._id_prefix = f"{sink._id_prefix}-{proc}"
    return sink


def _engine(pkg: str, models, spans_dir: str):
    """A warmed engine behind its front-end, journaling as ``engine-0``
    through a sink-less (parse-only) wire tracer, as a fleet worker does."""
    model, params = models[pkg]
    sink = _sink(pkg, spans_dir, "engine-0")
    if pkg == "jax":
        reg = JRegistry()
        engine = JServeEngine(model, JServeConfig(**SERVE), params,
                              registry=reg)
        engine.warmup()
        fe = jfleet.ServeFrontend(
            jfleet.EngineBackend(engine, spans=sink), reg,
            tracer=JWireTracer()).start()
    else:
        reg = MetricsRegistry()
        engine = ServeEngine(model, ServeConfig(**SERVE), params,
                             registry=reg)
        engine.warmup()
        fe = tfleet.ServeFrontend(
            tfleet.EngineBackend(engine, spans=sink), reg,
            tracer=WireTracer()).start()
    return engine, fe, sink


def _run(models, root, router_pkg: str, engine_pkg: str) -> str:
    spans_dir = str(root / f"{router_pkg}-over-{engine_pkg}" / "spans")
    os.makedirs(spans_dir)
    engine, efe, esink = _engine(engine_pkg, models, spans_dir)
    fleet = jfleet if router_pkg == "jax" else tfleet
    rsink = _sink(router_pkg, spans_dir, "fleet")
    obs = (JObs if router_pkg == "jax" else Obs)(spans=rsink)
    registry = JRegistry() if router_pkg == "jax" else MetricsRegistry()
    cfg = JFleetConfig() if router_pkg == "jax" else FleetConfig()
    router = fleet.FleetRouter(
        fleet.StaticEndpoints({"e0": (efe.host, efe.port)}), cfg, registry,
        workdir="", obs=obs)
    tracer = (JWireTracer if router_pkg == "jax" else WireTracer)(
        rsink, mint=True)
    rfe = fleet.ServeFrontend(router, registry, tracer=tracer).start()
    csink = _sink(engine_pkg, spans_dir, "client")
    client = tfleet.FleetClient(rfe.host, rfe.port, sink=csink)
    rng = np.random.default_rng(5)
    try:
        router.poll_once()
        for _ in range(ROUNDS):
            for s in range(SESSIONS):
                reply = client.submit(f"s{s}", rng.uniform(
                    1.0, 2.0, OBS_DIM).astype(np.float32))
                assert reply["engine"] == "e0" and len(reply["trace_id"]) == 16
    finally:
        client.close()
        rfe.stop()
        router.stop()
        efe.stop()
        engine.stop(drain=False)
        for sink in (csink, rsink, esink):
            sink.close()
    return spans_dir


@pytest.fixture(scope="module")
def span_dirs(models, tmp_path_factory):
    root = tmp_path_factory.mktemp("fleet-trace")
    return {pair: _run(models, root, *pair)
            for pair in (("jax", "torch"), ("torch", "jax"))}


@pytest.mark.parametrize("pair", [("jax", "torch"), ("torch", "jax")],
                         ids=["jax-router-port-engine",
                              "port-router-jax-engine"])
def test_every_trace_stitches_across_router_and_engine(span_dirs, pair):
    spans = tcollect.read_span_dir(span_dirs[pair])
    assert spans == jcollect.read_span_dir(span_dirs[pair])
    ids = tcollect.trace_ids(spans)
    assert len(ids) == SESSIONS * ROUNDS
    for tid in ids:
        stitched = tcollect.stitch(spans, tid)
        assert stitched == jcollect.stitch(spans, tid)
        assert stitched["errors"] == []
        assert stitched["procs"] == ["client", "engine-0", "fleet"]
        # The engine's readback child only when its consumer stamped
        # t_done before the front-end journaled the request.
        names = sorted(s["name"] for s in stitched["spans"]
                       if s["name"] != "readback")
        assert names == sorted([
            "client_submit", "frontend", "relay", "relay_attempt",
            "engine_recv", "engine_request", "queue_wait",
            "batch_wait", "device"]), names
    assert tcollect.migrated_traces(spans) == \
        jcollect.migrated_traces(spans) == []


def test_cli_obs_lists_and_renders_a_trace(span_dirs, capsys, tmp_path):
    run_dir = os.path.dirname(span_dirs[("jax", "torch")])
    assert cli.main(["obs", "--dir", run_dir, "--trace", "list"]) == 0
    listed = json.loads(capsys.readouterr().out)
    assert len(listed["traces"]) == SESSIONS * ROUNDS
    tid = next(iter(listed["traces"]))
    out = str(tmp_path / "trace.json")
    assert cli.main(["obs", "--dir", run_dir, "--trace", tid,
                     "--out", out]) == 0
    view = json.loads(capsys.readouterr().out)
    assert view["errors"] == [] and view["perfetto"] == out
    from sharetrade_tpu.obs import read_trace
    rendered = read_trace(out)          # the JAX reader of the port's file
    assert {e["args"]["name"] for e in rendered if e["ph"] == "M"} == {
        "client", "engine-0", "fleet"}
    assert cli.main(["obs", "--dir", run_dir, "--trace", "0" * 16]) == 1
    assert cli.main(["obs", "--dir", str(tmp_path), "--trace", "list"]) == 1


def test_engine_spans_read_the_done_stamp_once(tmp_path):
    """The engine's consumer stamps ``t_done`` after the completion
    callback, so it can land while the front-end journals the request's
    spans: the envelope and its readback child must read one value."""
    class Handle:
        t_enq, t_collected, t_dispatched, t_device = 1.0, 1.001, 1.002, 1.003
        outcome = "completed"
        reads = 0

        @property
        def t_done(self):
            Handle.reads += 1
            return None if Handle.reads == 1 else 1.5   # lands mid-journal

    sink = SpanSink(SpanJournal(str(tmp_path), "engine-0"))
    backend = tfleet.EngineBackend(engine=None, spans=sink)
    backend.trace_complete(("ab" * 8, "p.1", "", 0.0), Handle())
    sink.close()
    spans = {s["name"]: s for s in tcollect.read_span_dir(str(tmp_path))}
    env = spans["engine_request"]
    assert "readback" not in spans
    assert env["dur_us"] == pytest.approx(3000.0)
