"""Shared utilities (logging)."""
