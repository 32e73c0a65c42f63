"""Trading environment (only what serving needs so far)."""
