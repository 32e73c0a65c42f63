"""Stitch per-process span journals into one cross-process trace.

Every fleet process (client, frontend/router, each engine worker) appends
its finished wire spans to its OWN bounded CRC-framed journal
(obs/trace.py ``SpanJournal`` — ``spans-<proc>-<pid>.journal`` plus sealed
``.segNNNNNNNN`` segments under one shared spans directory). This module
is the read side: walk every journal, convert each process's raw
``perf_counter`` timestamps to a shared epoch-microsecond timeline using
the monotonic→epoch anchor its clock lines carry, group by trace id, and
emit one Perfetto-renderable trace per request.

The counterpart of the JAX package's ``obs/collect.py``: both read the same
journal format, so either stitches spans that either package journaled.

What a collector may assume (the cross-process contract):

- **parentage** — every span names its trace id, its own span id, and its
  parent span id ("" = root); within one stitched trace every non-empty
  parent id resolves to a span some process journaled, EXCEPT spans whose
  emitting process was SIGKILLed mid-request (their children survive as
  orphans and are reported, not dropped);
- **clock alignment** — span timestamps become comparable across
  processes only after applying each RECORD's own clock line (epoch −
  mono); same-host wall clocks make the residual error capture jitter,
  so interval nesting is verified with a small slack
  (:data:`NEST_SLACK_US`), never exact equality;
- **journal bounds** — journals rotate and prune oldest-first, and each
  record is self-describing (clock line first), so a stitched trace is
  complete only for requests younger than the retention window; pruning
  can never misalign surviving spans, only remove whole batches.
"""

from __future__ import annotations

import json
import os
from typing import Any, Iterator

from sharetrade_tpu_torch.data.journal import (
    iter_framed_records,
    segment_paths,
)
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("obs.collect")

#: Cross-process nesting slack (µs): same-host epoch clocks agree to well
#: under this; child intervals are asserted inside their parents only to
#: this tolerance.
NEST_SLACK_US = 2000.0


def span_journal_paths(spans_dir: str) -> list[str]:
    """Every span journal file under ``spans_dir`` — sealed segments
    first (oldest data), then each active file."""
    try:
        names = sorted(os.listdir(spans_dir))
    except FileNotFoundError:
        return []
    active = [os.path.join(spans_dir, n) for n in names
              if n.startswith("spans-") and n.endswith(".journal")]
    paths: list[str] = []
    for path in active:
        paths.extend(segment_paths(path))
        paths.append(path)
    return paths


def _iter_file_spans(path: str) -> Iterator[dict]:
    for _off, payload in iter_framed_records(path, warn=False):
        lines = payload.split(b"\n")
        if not lines:
            continue
        try:
            clock = json.loads(lines[0])
            offset = float(clock["epoch"]) - float(clock["mono"])
            proc, pid = clock["proc"], clock["pid"]
        except (ValueError, KeyError, TypeError):
            continue            # not a span batch; skip the record
        for raw in lines[1:]:
            try:
                ev = json.loads(raw)
            except ValueError:
                continue
            span = {"trace": ev["trace"], "span": ev["span"],
                    "parent": ev.get("parent", ""), "name": ev["name"],
                    "proc": proc, "pid": pid,
                    "ts_us": (float(ev["t0"]) + offset) * 1e6}
            if "t1" in ev:
                span["dur_us"] = (float(ev["t1"]) - float(ev["t0"])) * 1e6
            if ev.get("note"):
                span["note"] = ev["note"]
            yield span


def read_span_dir(spans_dir: str) -> list[dict]:
    """All spans from every journal under ``spans_dir``, clock-aligned to
    epoch microseconds (``ts_us``; complete spans carry ``dur_us``)."""
    spans: list[dict] = []
    for path in span_journal_paths(spans_dir):
        spans.extend(_iter_file_spans(path))
    return spans


def trace_ids(spans: list[dict]) -> dict[str, int]:
    """trace id -> span count, ordered by each trace's first timestamp."""
    first: dict[str, float] = {}
    counts: dict[str, int] = {}
    for s in spans:
        t = s["trace"]
        counts[t] = counts.get(t, 0) + 1
        if t not in first or s["ts_us"] < first[t]:
            first[t] = s["ts_us"]
    return {t: counts[t] for t in sorted(counts, key=first.get)}


def stitch(spans: list[dict], trace_id: str) -> dict:
    """One trace's spans, time-sorted, with the contract verified.

    Returns ``{"trace_id", "spans", "procs", "errors"}`` where ``errors``
    lists every violated invariant: an unresolved parent id, or a span
    interval escaping its parent's by more than :data:`NEST_SLACK_US`.
    An empty ``errors`` is the stitched-trace acceptance."""
    return _stitch_group([s for s in spans if s["trace"] == trace_id],
                         trace_id)


def _stitch_group(group: list[dict], trace_id: str) -> dict:
    """:func:`stitch` of spans already known to belong to ``trace_id``."""
    mine = sorted(group, key=lambda s: s["ts_us"])
    by_id = {s["span"]: s for s in mine}
    errors: list[str] = []
    for s in mine:
        parent = by_id.get(s["parent"]) if s["parent"] else None
        if s["parent"] and parent is None:
            errors.append(f"span {s['span']} ({s['name']}, {s['proc']}): "
                          f"parent {s['parent']} unresolved")
            continue
        if parent is None or "dur_us" not in parent:
            continue            # root, or parented under an instant
        p0 = parent["ts_us"] - NEST_SLACK_US
        p1 = parent["ts_us"] + parent["dur_us"] + NEST_SLACK_US
        s0 = s["ts_us"]
        s1 = s0 + s.get("dur_us", 0.0)
        if s0 < p0 or s1 > p1:
            errors.append(
                f"span {s['span']} ({s['name']}, {s['proc']}) "
                f"[{s0:.0f},{s1:.0f}]us escapes parent "
                f"{parent['span']} ({parent['name']}) "
                f"[{p0:.0f},{p1:.0f}]us")
    return {"trace_id": trace_id, "spans": mine,
            "procs": sorted({s["proc"] for s in mine}),
            "errors": errors}


def write_perfetto(stitched: dict, path: str) -> str:
    """Render a stitched trace as Chrome trace-event JSON (the same
    array format obs/trace.py writes — ui.perfetto.dev loads it
    directly). Each journaling process becomes one named Perfetto
    process row."""
    procs = {proc: i + 1 for i, proc in enumerate(stitched["procs"])}
    events: list[dict] = []
    for proc, pid in procs.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": proc}})
    for s in stitched["spans"]:
        args: dict[str, Any] = {"trace": s["trace"], "span": s["span"],
                                "parent": s["parent"]}
        if "note" in s:
            args["note"] = s["note"]
        ev = {"name": s["name"], "cat": "wire", "pid": procs[s["proc"]],
              "tid": 0, "ts": round(s["ts_us"], 3), "args": args}
        if "dur_us" in s:
            ev.update(ph="X", dur=round(s["dur_us"], 3))
        else:
            ev.update(ph="i", s="p")
        events.append(ev)
    with open(path, "w", encoding="utf-8") as f:
        f.write("[\n")
        f.write("".join(json.dumps(e) + ",\n" for e in events))
    return path


def collect_trace(spans_dir: str, trace_id: str,
                  out: str | None = None) -> dict:
    """Read + stitch + (optionally) render one trace: the body of ``cli obs
    --trace``."""
    stitched = stitch(read_span_dir(spans_dir), trace_id)
    if out and stitched["spans"]:
        stitched["perfetto"] = write_perfetto(stitched, out)
    return stitched


def migrated_traces(spans: list[dict]) -> list[dict]:
    """Stitched traces whose router relay MIGRATED mid-flight (an attempt
    span annotated ``migrate``), in :func:`trace_ids` order; each carries
    the set of engine procs whose spans made it into the record.

    The spans are grouped by trace id in one pass, and only the groups
    with a migrating attempt are stitched, so the cost is linear in the
    spans (the JAX version re-scans every span for each trace). The
    result is the JAX version's."""
    groups: dict[str, list[dict]] = {}
    migrated: set[str] = set()
    for s in spans:
        groups.setdefault(s["trace"], []).append(s)
        if (s["name"] == "relay_attempt"
                and s.get("note", "").startswith("migrate")):
            migrated.add(s["trace"])
    out: list[dict] = []
    for tid in trace_ids(spans):
        if tid not in migrated:
            continue
        stitched = _stitch_group(groups[tid], tid)
        stitched["engines"] = sorted(
            {s["proc"] for s in stitched["spans"]
             if s["proc"].startswith("engine-")})
        out.append(stitched)
    return out
