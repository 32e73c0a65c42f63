"""Serving tier: the continuous-batching engine, its weight-swap watcher,
its disk spill tier and its load drivers."""

from sharetrade_tpu_torch.serve.engine import (  # noqa: F401
    ServeDeadlineExceeded, ServeEngine, ServeEngineFailed, ServeRejected,
    ServeResult, SlotPool, WarmStore, latency_percentiles)
from sharetrade_tpu_torch.serve.swap import WeightSwapWatcher  # noqa: F401
