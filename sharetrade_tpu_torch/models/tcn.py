"""Temporal convolutional tick policy (TCN).

Counterpart of the JAX package's ``models/tcn.py``: the window transformer's
tick features, embedded, then blocks of a dilated causal convolution
(kernel 3, dilation 2^i, left-padded by 2·2^i so position t sees only
positions <= t), a tanh-approximated GELU (``jax.nn.gelu``'s default) and a
residual mixing layer; the market summary is the last position, to which a
projection of the portfolio features is added before the policy and value
heads. ``num_blocks=None`` sizes the stack so the receptive field
``1 + 2·(2^B - 1)`` covers the window (7 blocks at window 201).

The filters keep the JAX layout ``w: (K, C_in, C_out)``, so weights convert
leaf for leaf. The convolution is computed as one matrix product of the K
dilated taps side by side, ``[x_pad[t], x_pad[t+d], x_pad[t+2d]] @
w.reshape(K·C_in, C_out)``: the JAX convolution without a flip (the same
sum ``F.conv1d`` computes), accumulated in float32 and rounded once to the
activations' dtype, which is what both of the JAX package's paths give (its
f32 path asks for an f32 result and casts; its bf16 path returns bf16
straight). A matrix product, unlike cuDNN's convolution backward, gives the
same bits eagerly and inside a CUDA graph, and does not fall to TF32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.models.core import (
    Model, ModelOut, compute_dtype, dense, dense_init, portfolio_features,
    tick_window_features)

KERNEL = 3


def default_num_blocks(window: int) -> int:
    """Blocks for the dilated receptive field ``1 + (K-1)·(2^B - 1)`` to
    cover ``window``."""
    return max(1, math.ceil(
        math.log2(max((window - 1) / (KERNEL - 1) + 1, 2))))


def _conv_init(gen: torch.Generator, kernel: int, c_in: int, c_out: int,
               device) -> dict:
    """He-normal (K, C_in, C_out) filter and a zero bias."""
    std = math.sqrt(2.0 / (kernel * c_in))
    w = torch.randn((kernel, c_in, c_out), generator=gen) * std
    return {"w": w.to(device), "b": torch.zeros((c_out,), device=device)}


def _causal_conv(p: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """(B, W, C_in) -> (B, W, C_out), position t reading positions t,
    t - d, t - 2d (zeros before the window)."""
    width = x.shape[1]
    pad = (KERNEL - 1) * dilation
    xp = F.pad(x, (0, 0, pad, 0))
    taps = torch.cat([xp[:, j * dilation:j * dilation + width]
                      for j in range(KERNEL)], dim=-1)       # (B, W, K·C)
    return torch.matmul(taps, p["w"].reshape(-1, p["w"].shape[-1])) + p["b"]


def tcn_policy(obs_dim: int = 203, num_actions: int = 3, *,
               channels: int = 64, num_blocks: int | None = None,
               device: torch.device | str | None = None) -> Model:
    """Build the TCN (``model.kind="tcn"``, ``model.hidden_dim`` channels)
    on ``device`` (``cuda`` when None)."""
    device = resolve_device(device)
    window = obs_dim - 2
    if num_blocks is None:
        num_blocks = default_num_blocks(window)

    def init(gen: torch.Generator) -> dict:
        params = {
            "embed": dense_init(gen, 3, channels, device=device),
            "port": dense_init(gen, 3, channels, scale=0.02, device=device),
            "policy": dense_init(gen, channels, num_actions, scale=0.01,
                                 device=device),
            "value": dense_init(gen, channels, 1, device=device),
            "blocks": [],
        }
        for _ in range(num_blocks):
            params["blocks"].append({
                "conv": _conv_init(gen, KERNEL, channels, channels, device),
                "mix": dense_init(gen, channels, channels, scale=0.02,
                                  device=device),
            })
        return params

    def apply_batch(params, obs, carry):
        dtype = compute_dtype(params)
        x = dense(params["embed"], tick_window_features(obs, window).to(dtype))
        for i, blk in enumerate(params["blocks"]):
            h = F.gelu(_causal_conv(blk["conv"], x, 2 ** i),
                       approximate="tanh")
            x = x + dense(blk["mix"], h)
        port = portfolio_features(obs[:, window], obs[:, window + 1],
                                  obs[:, window - 1])
        summary = x[:, -1] + dense(params["port"], port.to(dtype))
        logits = dense(params["policy"], summary).float()
        value = dense(params["value"], summary).float()[:, 0]
        return ModelOut(logits=logits, value=value), carry

    return Model(init=init, init_carry=dict, apply_batch=apply_batch,
                 obs_dim=obs_dim, name="tcn", device=device,
                 num_actions=num_actions)
