"""The transformer block's FFN half.

Counterpart of the JAX package's ``models/ffn.py``, dense path only:
``mlp_out(gelu(mlp_in(h)))`` with the tanh-approximated GELU that
``jax.nn.gelu`` computes by default. The mixture-of-experts dispatch is not
yet ported (``models.build_model`` refuses ``model.moe_experts > 0``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sharetrade_tpu_torch.models.core import dense


def ffn_apply(blk: dict, h: torch.Tensor) -> torch.Tensor:
    """Apply the block's dense FFN to ``h`` (..., d)."""
    return dense(blk["mlp_out"], F.gelu(dense(blk["mlp_in"], h),
                                        approximate="tanh"))
