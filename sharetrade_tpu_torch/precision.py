"""Precision policy: bf16 compute with fp32 master weights.

Counterpart of the JAX package's ``precision.py``. Masters stay float32;
:meth:`PrecisionPolicy.cast_compute` makes the compute copy the forwards
and backwards run on (bfloat16 under ``bf16_mixed``), with float32
accumulation in every matrix product (``models.core.dense``,
``ops.attention``). Gradients of the compute copy reach the float32 masters
through the fused update, which upcasts them inside its own pass (every
``fused_update`` setting takes that pass: see ``agents.base.make_update_fn``).
The recurrent carry is cast once, through the
model's own hook where it has one (the episode transformer keeps its price
history ``hist`` in float32).

In fp32 mode every helper returns its argument object untouched.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from sharetrade_tpu_torch.config import ConfigError, PrecisionConfig

MODES = ("fp32", "bf16_mixed")


def cast_float_leaves(tree: Any, dtype: torch.dtype) -> Any:
    """Cast every floating tensor of a nested dict/list tree to ``dtype``;
    integer tensors pass through."""
    if isinstance(tree, dict):
        return {k: cast_float_leaves(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_float_leaves(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


@dataclass(frozen=True)
class PrecisionPolicy:
    mode: str = "fp32"
    fused_update: str = "auto"

    def __post_init__(self):
        if self.mode not in MODES:
            raise ConfigError(
                f"unknown precision.mode {self.mode!r}; choose from {MODES}")
        if self.fused_update not in ("auto", "on", "off"):
            raise ConfigError(
                f"precision.fused_update must be 'auto', 'on' or 'off', "
                f"got {self.fused_update!r}")

    @property
    def mixed(self) -> bool:
        return self.mode == "bf16_mixed"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.mixed else torch.float32

    def cast_compute(self, params: Any) -> Any:
        """fp32 masters -> the compute copy. Identity in fp32 mode."""
        if not self.mixed:
            return params
        return cast_float_leaves(params, self.compute_dtype)

    def cast_carry(self, carry: Any, model: Any = None) -> Any:
        """Recurrent state -> the compute dtype, through ``model.cast_carry``
        when the model provides one. Identity in fp32 mode."""
        if not self.mixed:
            return carry
        hook = getattr(model, "cast_carry", None)
        if hook is not None:
            return hook(carry, self.compute_dtype)
        return cast_float_leaves(carry, self.compute_dtype)


FP32 = PrecisionPolicy()


def policy_from_config(cfg: PrecisionConfig | None) -> PrecisionPolicy:
    if cfg is None:
        return FP32
    return PrecisionPolicy(mode=cfg.mode, fused_update=cfg.fused_update)
