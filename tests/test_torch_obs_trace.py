"""The port's span tracer, span journal and sink, flight recorder and metrics
exporter against the JAX package's, in one process.

The same calls, driven by one fake clock (``time.perf_counter`` and
``time.time`` advance by a fixed step a read), go through both packages:

- the span tracer writes the same ``trace.jsonl`` byte for byte, and each
  package's ``read_trace`` reads the other's file;
- the span journal and its sink write the same framed records byte for
  byte (clock anchor included), and each package's collector reads the
  other's journal to the same spans;
- journal bounds: rotation and oldest-first pruning, a torn tail and the
  sink ring's drops come out as in the JAX package's own tests
  (``tests/test_obs_collect.py`` ``TestJournalBounds``), for the port's
  journal read by both collectors;
- the flight recorder's bundle is the same, and a ``RingLogHandler`` on the
  shared ``sharetrade`` logger feeds both packages' rings (compared by
  kind: a process holding both packages sees both packages' log lines);
- the metrics exporter drains the same registry contents into the same
  ``metrics.jsonl`` record and ``metrics.prom`` text.

Everything here is exact: file formats, names and counts.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import time

import pytest

from sharetrade_tpu.obs import collect as jcollect
from sharetrade_tpu.obs import exporter as jexporter
from sharetrade_tpu.obs import flight as jflight
from sharetrade_tpu.obs import trace as jtrace
from sharetrade_tpu.utils.metrics import MetricsRegistry as JRegistry
from sharetrade_tpu_torch.obs import collect as tcollect
from sharetrade_tpu_torch.obs import exporter as texporter
from sharetrade_tpu_torch.obs import flight as tflight
from sharetrade_tpu_torch.obs import trace as ttrace
from sharetrade_tpu_torch.obs.hist import Histogram
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

PACKAGES = {"jax": (jtrace, jcollect, jflight, jexporter),
            "torch": (ttrace, tcollect, tflight, texporter)}


@pytest.fixture
def fake_clock(monkeypatch):
    """Restart the fake clock: every read advances it by 1.25 ms."""
    def restart():
        ticks = itertools.count()
        monkeypatch.setattr(time, "perf_counter",
                            lambda: 100.0 + 0.00125 * next(ticks))
        monkeypatch.setattr(time, "time",
                            lambda: 1.7e9 + 0.00125 * next(ticks))
    return restart


def _tracer_script(trace_mod, path: str) -> None:
    tracer = trace_mod.SpanTracer(path, flush_every=3)
    with tracer.span("dispatch", chunk=0, k=1):
        with tracer.span("readback", chunk=0, k=1):
            pass
    tracer.instant("phase:training")
    with tracer.span("host_process"):
        pass
    tracer.emit_lines(['{"name":"serve_request","ph":"X","ts":1.000,'
                       '"dur":2.000,"pid":1,"tid":1000001,"args":{}}'])
    tracer.flush()
    with tracer.span("checkpoint_save", step=4):
        pass
    tracer.close()
    assert not tracer.enabled
    # Disabled: the shared null context, no file.
    off = trace_mod.SpanTracer(None)
    assert not off.enabled
    with off.span("x"):
        off.instant("y")


def test_span_tracer_files_are_byte_equal_and_cross_read(tmp_path,
                                                         fake_clock):
    paths = {}
    for pkg, (trace_mod, *_) in PACKAGES.items():
        fake_clock()
        paths[pkg] = str(tmp_path / f"{pkg}.jsonl")
        _tracer_script(trace_mod, paths[pkg])
    raw = {pkg: open(p, "rb").read() for pkg, p in paths.items()}
    assert raw["torch"] == raw["jax"]
    events = jtrace.read_trace(paths["torch"])
    assert events == ttrace.read_trace(paths["jax"])
    assert [e["name"] for e in events] == [
        "readback", "dispatch", "phase:training", "host_process",
        "serve_request", "checkpoint_save"]
    assert events[1]["args"] == {"chunk": 0, "k": 1}
    assert sorted(os.listdir(tmp_path)) == ["jax.jsonl", "torch.jsonl"]


def _journal_script(trace_mod, spans_dir: str):
    sink = trace_mod.SpanSink(trace_mod.SpanJournal(spans_dir, "fleet"),
                              flush_every=4)
    ids = [sink.new_span_id() for _ in range(3)]
    t0 = time.perf_counter()
    sink.span("aa" * 8, ids[0], "", "relay", t0, t0 + 0.004, "migrated")
    sink.span("aa" * 8, ids[1], ids[0], "relay_attempt", t0 + 0.001,
              t0 + 0.002, "first status 200")
    sink.instant("bb" * 8, ids[2], "", "engine_recv", flush=True)
    sink.span("bb" * 8, sink.new_span_id(), ids[2], "engine_request",
              t0, t0 + 0.003)
    sink.close()
    return sink


def test_span_journals_are_byte_equal_and_cross_read(tmp_path, fake_clock):
    dirs, sinks = {}, {}
    for pkg, (trace_mod, *_) in PACKAGES.items():
        fake_clock()
        dirs[pkg] = str(tmp_path / pkg)
        sinks[pkg] = _journal_script(trace_mod, dirs[pkg])
    names = {pkg: os.listdir(d) for pkg, d in dirs.items()}
    assert names["torch"] == names["jax"] == [
        f"spans-fleet-{os.getpid()}.journal"]
    raw = {pkg: open(os.path.join(d, names[pkg][0]), "rb").read()
           for pkg, d in dirs.items()}
    assert raw["torch"] == raw["jax"]
    spans = jcollect.read_span_dir(dirs["torch"])
    assert spans == tcollect.read_span_dir(dirs["jax"])
    assert [s["name"] for s in spans] == [
        "relay", "relay_attempt", "engine_recv", "engine_request"]
    assert "dur_us" not in spans[2] and spans[0]["note"] == "migrated"
    assert sinks["torch"].dropped == sinks["jax"].dropped == 0


def _make_sink(trace_mod, spans_dir, proc, *, epoch, mono, **journal_kw):
    """A sink whose journal carries a controlled clock anchor (the JAX
    tests' helper)."""
    journal = trace_mod.SpanJournal(str(spans_dir), proc, **journal_kw)
    journal.epoch, journal.mono = epoch, mono
    journal._clock_line = json.dumps(
        {"clock": 1, "proc": proc, "pid": journal.pid,
         "epoch": epoch, "mono": mono}, separators=(",", ":")).encode()
    return trace_mod.SpanSink(journal)


@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_rotation_and_oldest_first_pruning(tmp_path, reader):
    sink = _make_sink(ttrace, tmp_path, "fleet", epoch=0.0, mono=0.0,
                      max_records=2, max_segments=2)
    for i in range(12):     # one record per flush
        sink.span("t1", f"a.{i}", "", "step", float(i), i + 0.5)
        sink.flush()
    sink.close()
    segs = [n for n in os.listdir(tmp_path) if ".seg" in n]
    assert len(segs) == 2   # pruned down from 6 rotations
    spans = PACKAGES[reader][1].read_span_dir(str(tmp_path))
    assert sorted(int(s["span"].split(".")[1]) for s in spans) == \
        list(range(8, 12))


@pytest.mark.parametrize("reader", ["jax", "torch"])
def test_torn_tail_loses_only_the_torn_record(tmp_path, reader):
    sink = _make_sink(ttrace, tmp_path, "fleet", epoch=0.0, mono=0.0)
    sink.span("t1", "a.1", "", "whole", 1.0, 2.0)
    sink.flush()
    sink.span("t1", "a.2", "", "torn", 3.0, 4.0)
    sink.close()
    path = sink._journal.path
    with open(path, "rb") as f:
        raw = f.read()
    with open(path, "wb") as f:
        f.write(raw[:-7])   # tear mid-record
    spans = PACKAGES[reader][1].read_span_dir(str(tmp_path))
    assert [s["span"] for s in spans] == ["a.1"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_sink_ring_is_bounded_and_counts_drops(tmp_path, pkg):
    """The same overflow in both packages' sinks: the same drops, and the
    newest ring-ful journaled (read by the other package's collector)."""
    other = "torch" if pkg == "jax" else "jax"
    sink = _make_sink(PACKAGES[pkg][0], tmp_path, "fleet", epoch=0.0,
                      mono=0.0)
    sink._buf = type(sink._buf)(maxlen=4)
    sink._flush_every = 100     # never auto-flush: force overflow
    for i in range(10):
        sink.span("t1", f"a.{i}", "", "s", float(i), i + 0.1)
    assert sink.dropped == 6
    sink.close()
    spans = PACKAGES[other][1].read_span_dir(str(tmp_path))
    assert [s["span"] for s in spans] == [f"a.{i}" for i in range(6, 10)]


def test_flight_bundles_are_equal_and_logs_reach_both_rings(tmp_path,
                                                           fake_clock):
    bundles, recorders, handlers = {}, {}, {}
    logger = logging.getLogger("sharetrade")
    try:
        for pkg, (_, _, flight_mod, _) in PACKAGES.items():
            recorders[pkg] = flight_mod.FlightRecorder(4)
            handlers[pkg] = flight_mod.RingLogHandler(recorders[pkg])
            logger.addHandler(handlers[pkg])
        logging.getLogger("sharetrade.test").warning("ring %d", 7)
        logging.getLogger("sharetrade.test").info("below the level")
        for pkg, (_, _, flight_mod, _) in PACKAGES.items():
            fake_clock()
            rec = flight_mod.FlightRecorder(3)
            for c in range(5):
                rec.record("chunk_metrics", chunk=c, loss=0.5 * c)
            rec.record("lifecycle", frm="training", to="failed")
            path = str(tmp_path / f"{pkg}.json")
            assert rec.dump(path, reason="supervision", error="boom",
                            next_chunk=5) == path
            assert rec.last_chunk == 4 and rec.dumps == 1
            with open(path) as f:
                bundles[pkg] = json.load(f)
    finally:
        for handler in handlers.values():
            logger.removeHandler(handler)
    assert bundles["torch"] == bundles["jax"]
    assert bundles["torch"]["failing_chunk"] == 4
    assert [e["kind"] for e in bundles["torch"]["events"]] == [
        "chunk_metrics", "chunk_metrics", "lifecycle"]
    for rec in recorders.values():
        logs = [e for e in rec.snapshot() if e["kind"] == "log"]
        assert [(e["level"], e["message"]) for e in logs] == [
            ("WARNING", "ring 7")]
    assert not [f for f in os.listdir(tmp_path) if ".tmp-" in f]


def test_metrics_exporters_write_the_same_files(tmp_path, fake_clock):
    from sharetrade_tpu.obs.hist import Histogram as JHistogram
    out = {}
    for pkg, registry, hist in (("jax", JRegistry(), JHistogram),
                                ("torch", MetricsRegistry(), Histogram)):
        fake_clock()
        registry.record("loss", 0.25)
        registry.inc("checkpoints_total", 2)
        h = registry.attach_histogram("train_chunk_seconds", hist())
        for v in (0.2, 3.0, 41.0):
            h.observe(v)
        run_dir = tmp_path / pkg
        run_dir.mkdir()
        exp = PACKAGES[pkg][3].MetricsExporter(registry, str(run_dir),
                                               interval_s=60.0)
        assert exp.drain() and not exp.drain()     # unchanged: skipped
        exp.stop()
        out[pkg] = ((run_dir / "metrics.prom").read_text(),
                    [json.loads(ln) for ln in
                     (run_dir / "metrics.jsonl").read_text().splitlines()])
    assert out["torch"][0] == out["jax"][0]
    assert [{k: v for k, v in r.items() if k != "ts"}
            for r in out["torch"][1]] == \
        [{k: v for k, v in r.items() if k != "ts"} for r in out["jax"][1]]
    parsed = jexporter.parse_prom_text(out["torch"][0])
    assert parsed["histograms"]["sharetrade_train_chunk_seconds"][
        "count"] == 3
    assert parsed == texporter.parse_prom_text(out["jax"][0])
