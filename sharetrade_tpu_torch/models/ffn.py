"""The transformer block's FFN half: dense MLP or mixture-of-experts.

Counterpart of the JAX package's ``models/ffn.py``, single-device
arguments: the dense ``mlp_out(gelu(mlp_in(h)))`` with the tanh-approximated
GELU that ``jax.nn.gelu`` computes by default, or the block's expert bank
(``parallel/moe.py``): dense-mask top-1 at ``moe_top_k=0``, capacity-
bucketed top-k dispatch otherwise. The ep-sharded and all_to_all forms are
not ported (``models.build_model`` refuses them).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from sharetrade_tpu_torch.models.core import dense


def ffn_apply(blk: dict, h: torch.Tensor, *, moe_experts: int = 0,
              moe_top_k: int = 0, moe_capacity_factor: float = 1.25):
    """Apply the block's FFN to ``h`` (..., d). Returns ``(y, aux)``: ``y``
    shaped like ``h``, ``aux`` the MoE load-balance loss (0.0 for the
    dense FFN)."""
    if not moe_experts:
        return (dense(blk["mlp_out"], F.gelu(dense(blk["mlp_in"], h),
                                             approximate="tanh")),
                torch.zeros((), dtype=torch.float32, device=h.device))
    from sharetrade_tpu_torch.parallel import moe as moe_lib
    flat = h.reshape(-1, h.shape[-1])
    if moe_top_k:
        y, aux = moe_lib.moe_apply_topk(
            blk["moe"], flat, top_k=moe_top_k,
            capacity_factor=moe_capacity_factor)
    else:
        y, aux = moe_lib.moe_apply(blk["moe"], flat)
    return y.reshape(h.shape), aux
