"""Parallel layers. Ported so far: the single-device mixture-of-experts
FFN (``moe.py``)."""
