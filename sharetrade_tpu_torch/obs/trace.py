"""Trace identity of the fleet wire.

Only :func:`new_trace_id` of the JAX package's ``obs/trace.py`` is ported,
in the JAX id format. Its callers, the fleet client's span sink, the span
tracer and the span journal, wait for ``obs.enabled`` (ROADMAP item 13).
"""

from __future__ import annotations

import os


def new_trace_id() -> str:
    """A fresh 16-hex-char trace id (random, collision-free in practice)."""
    return os.urandom(8).hex()
