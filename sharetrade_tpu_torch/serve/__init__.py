"""Serving tier: the continuous-batching engine and its load driver."""

from sharetrade_tpu_torch.serve.engine import (  # noqa: F401
    ServeEngine, ServeRejected, ServeResult, SlotPool, latency_percentiles)
