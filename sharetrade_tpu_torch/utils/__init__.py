"""Shared utilities: logging, the metrics registry and the step timer."""
