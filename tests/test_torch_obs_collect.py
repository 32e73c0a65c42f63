"""The port's trace collector (``obs/collect.py``) against the JAX package's,
on one seeded span set.

About 200 traces of a router and two engines are journaled through the
port's span sink, each process with its own clock anchor (perf_counter
origins seconds apart). The set holds clean traces, traces whose relay
migrated (an attempt annotated ``migrate:...``) with the killed engine's
``engine_recv`` instant, spans whose parent was never journaled, and
children that escape their parent. Both collectors read the span directory
to the same spans, and give the same ``trace_ids``, the same ``stitch`` of
every trace (spans, processes, errors), the same ``migrated_traces`` and
the same Perfetto file. The port's ``migrated_traces`` groups the spans in
one pass; its result must still be the JAX one's. Exact throughout.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from sharetrade_tpu.obs import collect as jcollect
from sharetrade_tpu_torch.obs import collect as tcollect
from sharetrade_tpu_torch.obs.trace import SpanJournal, SpanSink

TRACES = 200
#: Each process's (epoch, mono) anchor: perf_counter origins far apart.
ANCHORS = {"fleet": (1.7e9, 50.0), "engine-0": (1.7e9, 9050.0),
           "engine-1": (1.7e9 + 0.5, 3.25)}


def _sink(spans_dir, proc: str) -> SpanSink:
    epoch, mono = ANCHORS[proc]
    journal = SpanJournal(str(spans_dir), proc, max_records=16)
    journal.epoch, journal.mono = epoch, mono
    journal._clock_line = json.dumps(
        {"clock": 1, "proc": proc, "pid": journal.pid, "epoch": epoch,
         "mono": mono}, separators=(",", ":")).encode()
    return SpanSink(journal, flush_every=16)


@pytest.fixture(scope="module")
def spans_dir(tmp_path_factory):
    """The seeded span set, journaled by the port's sinks."""
    root = tmp_path_factory.mktemp("spans")
    sinks = {proc: _sink(root, proc) for proc in ANCHORS}
    rng = np.random.default_rng(20261018)

    def local(proc: str, epoch_t: float) -> float:
        """An epoch time on ``proc``'s own perf_counter clock."""
        epoch, mono = ANCHORS[proc]
        return epoch_t - epoch + mono

    for i in range(TRACES):
        tid = f"{i:016x}"
        fleet = sinks["fleet"]
        t0 = 1.7e9 + 1.0 + i * 0.01 + float(rng.uniform(0, 0.005))
        relay, attempt = fleet.new_span_id(), fleet.new_span_id()
        kind = i % 5
        engine = f"engine-{i % 2}"
        end = t0 + 0.004
        fleet.span(tid, relay, "", "relay", local("fleet", t0),
                   local("fleet", end), "migrated" if kind == 1 else "")
        if kind == 1:
            # A migrated relay: the first attempt died with its engine,
            # whose eagerly flushed engine_recv survives.
            fleet.span(tid, attempt, relay, "relay_attempt",
                       local("fleet", t0), local("fleet", t0 + 0.001),
                       "first connection reset")
            dead = sinks["engine-1"]
            dead.span(tid, dead.new_span_id(), attempt, "engine_recv",
                      local("engine-1", t0 + 0.0005), None)
            attempt = fleet.new_span_id()
            fleet.span(tid, attempt, relay, "relay_attempt",
                       local("fleet", t0 + 0.001), local("fleet", end),
                       "migrate:connection reset status 200")
            engine = "engine-0"
        else:
            fleet.span(tid, attempt, relay, "relay_attempt",
                       local("fleet", t0), local("fleet", end),
                       "first status 200")
        sink = sinks[engine]
        env = sink.new_span_id()
        e0, e1 = t0 + 0.001, t0 + 0.003
        if kind == 3:
            e1 = t0 + 0.009     # escapes the attempt by 5 ms
        sink.span(tid, env, attempt, "engine_request", local(engine, e0),
                  local(engine, e1), "completed")
        for name, a, b in (("queue_wait", e0, e0 + 0.0005),
                           ("device", e0 + 0.0005, e1)):
            sink.span(tid, sink.new_span_id(), env, name, local(engine, a),
                      local(engine, b))
        if kind == 4:
            sink.span(tid, sink.new_span_id(), "ffff.1", "orphan",
                      local(engine, e0), local(engine, e0 + 0.0001))
    for sink in sinks.values():
        sink.close()
    return str(root)


@pytest.fixture(scope="module")
def spans(spans_dir):
    got = tcollect.read_span_dir(spans_dir)
    assert got == jcollect.read_span_dir(spans_dir)
    return got


def test_span_journal_paths_and_trace_ids_agree(spans_dir, spans):
    assert tcollect.span_journal_paths(spans_dir) == \
        jcollect.span_journal_paths(spans_dir)
    assert any(".seg" in p for p in tcollect.span_journal_paths(spans_dir))
    ids = tcollect.trace_ids(spans)
    assert ids == jcollect.trace_ids(spans)
    assert len(ids) == TRACES


def test_every_trace_stitches_the_same(spans):
    kinds = {"clean": 0, "errors": 0}
    for tid in tcollect.trace_ids(spans):
        got = tcollect.stitch(spans, tid)
        assert got == jcollect.stitch(spans, tid)
        kinds["errors" if got["errors"] else "clean"] += 1
    # kinds 3 (escaping child) and 4 (unresolved parent) carry errors.
    assert kinds == {"clean": 120, "errors": 80}
    assert tcollect.stitch(spans, "0" * 16) == \
        jcollect.stitch(spans, "0" * 16)


def test_migrated_traces_agree(spans):
    got = tcollect.migrated_traces(spans)
    assert got == jcollect.migrated_traces(spans)
    assert len(got) == TRACES // 5
    assert all(t["engines"] == ["engine-0", "engine-1"] and not t["errors"]
               for t in got)


def test_write_perfetto_and_collect_trace_agree(spans_dir, spans, tmp_path):
    tid = next(iter(tcollect.trace_ids(spans)))
    stitched = tcollect.stitch(spans, tid)
    ours = tcollect.write_perfetto(stitched, str(tmp_path / "t.json"))
    theirs = jcollect.write_perfetto(stitched, str(tmp_path / "j.json"))
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got = tcollect.collect_trace(spans_dir, tid, out=str(tmp_path / "c.json"))
    want = jcollect.collect_trace(spans_dir, tid,
                                  out=str(tmp_path / "c.json"))
    assert got == want and got["perfetto"] == str(tmp_path / "c.json")
