"""The single-asset trading environment's interface constants.

Counterpart of the JAX package's ``env/trading.py``. Serving needs only the
action encoding and the observation layout; ``step``/``reset`` and the
episode scan come with the training slice.

Observation layout (``window + 2`` floats): the ``window`` most recent
prices, oldest first, then the budget and the share count. The trade of a
step executes at the price just after the window.
"""

from __future__ import annotations

BUY, SELL, HOLD = 0, 1, 2  # reference action order: actions = Seq(Buy, Sell, Hold)


def obs_dim(window: int) -> int:
    """Observation width for a price window: prices + budget + shares."""
    return window + 2
