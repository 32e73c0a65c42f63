"""Readers of the roofline artifact (``roofline.json``).

The JAX package's ``obs/roofline.py`` writes ``roofline.json`` from XLA's
compiled-cost analysis; the port has no capture yet (``obs.roofline`` is
refused, ROADMAP item 13b). Its readers are pure JSON and are copied here,
so ``cli obs`` summarises a run directory that holds one.
"""

from __future__ import annotations

import json
import os

#: The artifact's file name inside a run directory.
ARTIFACT = "roofline.json"


def read_roofline(run_dir: str) -> dict | None:
    """Load a run dir's roofline artifact; None when absent/unreadable."""
    path = os.path.join(run_dir, ARTIFACT)
    if not os.path.isfile(path):
        return None
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except Exception:
        return None


def summarize_roofline(bundle: dict, *, top: int = 3) -> dict:
    """The ``cli obs`` condensation: per-program headline numbers plus the
    top compute-bound / memory-bound programs by FLOPs."""
    programs = bundle.get("programs", {})

    def _brief(name: str) -> dict:
        p = programs[name]
        return {
            "program": name,
            "flops": p.get("flops"),
            "bytes_accessed": p.get("bytes_accessed"),
            "arithmetic_intensity": p.get("arithmetic_intensity"),
            "discrepancy": p.get("discrepancy", False),
        }

    by_flops = sorted(
        (n for n in programs if programs[n].get("flops")),
        key=lambda n: programs[n]["flops"], reverse=True)
    return {
        "schema_version": bundle.get("schema_version"),
        "ridge_flops_per_byte": bundle.get("ridge_flops_per_byte"),
        "programs": len(programs),
        "compute_bound": [
            _brief(n) for n in by_flops
            if programs[n].get("classification") == "compute-bound"][:top],
        "memory_bound": [
            _brief(n) for n in by_flops
            if programs[n].get("classification") == "memory-bound"][:top],
    }
