"""A small on-disk time-series ring for fleet telemetry history.

A copy of the JAX package's ``obs/tsdb.py``. The fleet router publishes
last-value gauges each poll (``fleet_status.json``); this ring keeps their
recent history — one JSONL row per poll, retention bounded by rows, not
time — which the fleet autoscaler (``fleet/autoscale.py``) reads its load
signal from.

Write discipline: plain buffered appends on the poller thread (one row per
``fleet.telemetry_poll_s``, no fsync — history is telemetry, a torn tail
loses one row). Past twice the retention bound the file is compacted by
atomic rewrite (tmp + ``os.replace``) keeping the newest ``max_rows`` rows,
so readers see either the old file or the compacted one, never a partial
rewrite.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any

from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("obs.tsdb")

#: The fleet router's per-poll gauge history, written next to
#: fleet_status.json in the fleet workdir (fleet/router.py) and read by the
#: autoscaler (fleet/autoscale.py).
FLEET_HISTORY_FILE = "fleet_history.jsonl"


class TsdbRing:
    """Bounded JSONL history at ``path`` (see module docstring)."""

    def __init__(self, path: str, *, max_rows: int = 2048):
        self.path = path
        self.max_rows = max(1, int(max_rows))
        self._lock = threading.Lock()
        self._rows_in_file = sum(1 for _ in self._iter_lines())
        self._fh = open(path, "a", encoding="utf-8")

    def _iter_lines(self):
        try:
            with open(self.path, encoding="utf-8") as f:
                yield from f
        except OSError:
            return

    def append(self, row: dict[str, Any]) -> None:
        """Append one poll row; compacts past 2x the retention bound."""
        line = json.dumps(row, separators=(",", ":"))
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line + "\n")
            self._fh.flush()
            self._rows_in_file += 1
            if self._rows_in_file > 2 * self.max_rows:
                self._compact_locked()

    def _compact_locked(self) -> None:
        self._fh.close()
        keep = [ln for ln in self._iter_lines()
                if ln.strip()][-self.max_rows:]
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.writelines(keep)
        os.replace(tmp, self.path)  # fsync-not-needed: bounded telemetry
        self._fh = open(self.path, "a", encoding="utf-8")
        self._rows_in_file = len(keep)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_history(path: str, last_n: int = 0) -> list[dict]:
    """The newest ``last_n`` rows (0 = all retained), tolerating a torn
    final line."""
    rows: list[dict] = []
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                try:
                    rows.append(json.loads(line))
                except ValueError:
                    continue        # torn tail row
    except OSError:
        return []
    return rows[-last_n:] if last_n > 0 else rows


def summarize_history(rows: list[dict],
                      keys: tuple = ("fleet_p50_ms", "fleet_p99_ms",
                                     "fleet_engines_live",
                                     "fleet_window_requests")) -> dict:
    """min/max/last per tracked gauge over ``rows``: "fleet p99 over the
    last N windows" rather than only "right now"."""
    summary: dict[str, Any] = {"rows": len(rows)}
    if not rows:
        return summary
    if rows[0].get("ts") is not None and rows[-1].get("ts") is not None:
        summary["window_s"] = round(rows[-1]["ts"] - rows[0]["ts"], 3)
    for key in keys:
        vals = [r[key] for r in rows
                if isinstance(r.get(key), (int, float))]
        if vals:
            summary[key] = {"min": min(vals), "max": max(vals),
                            "last": vals[-1]}
    return summary
