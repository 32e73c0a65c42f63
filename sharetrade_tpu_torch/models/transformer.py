"""Window-mode transformer tick policy (BASELINE.json config 5).

Counterpart of the JAX package's ``models/transformer.py``: the
observation's price window is a sequence of tick tokens (price relative to
the window's last price, log-return, and a zero channel), followed by a
portfolio token (``portfolio_features``) whose output feeds the policy and
value heads. Pre-LN blocks; every layer's attention is causal and unbanded
over the whole ``window + 1`` tokens, through
``ops.attention.flash_attention`` (``flash_fwd`` on the card, and in the
backward ``flash_bwd_dq`` / ``flash_bwd_dkv``).

``num_assets`` = A > 1 tokenizes the portfolio observation
(``env/portfolio.py``: A windows, the budget, A share counts) as A blocks of
``[window tick tokens | that asset's portfolio token]``, positions tiled per
block, each block tagged with a learned asset embedding (drawn last, so a
single-asset model draws the same weights per seed as before the
embedding existed); the summary is the mean of the A portfolio tokens'
outputs, then ``final_ln``. At A = 1 this is exactly the single-asset
layout.

The FFN is dense or a mixture of experts (``models/ffn.py``); the blocks'
MoE balance losses, averaged over the layers, come back as
``ModelOut.aux``. The model is stateless (``init_carry()`` is ``{}``) and
gives ``apply_batch`` only: the generic rollout, the folded replay and the
serving engine's generic program run it.

Not ported: ring / ulysses attention and pipelined blocks (they need a
mesh; ``models.build_model`` refuses them).
"""

from __future__ import annotations

import torch

from sharetrade_tpu_torch.config import ConfigError
from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.models.core import (
    Model, ModelOut, compute_dtype, dense, dense_init, layer_norm,
    portfolio_features, tick_window_features)
from sharetrade_tpu_torch.models.ffn import ffn_apply
from sharetrade_tpu_torch.ops.attention import flash_attention


def transformer_policy(obs_dim: int = 203, num_actions: int = 3, *,
                       num_layers: int = 2, num_heads: int = 4,
                       head_dim: int = 64, mlp_ratio: int = 4,
                       device: torch.device | str | None = None,
                       attention_fn=None, moe_experts: int = 0,
                       moe_top_k: int = 0, moe_capacity_factor: float = 1.25,
                       num_assets: int = 1) -> Model:
    """Build the window-mode policy on ``device`` (``cuda`` when None;
    raises without one). ``attention_fn(q, k, v) -> out`` over (B, H, T,
    Dh) replaces the causal flash attention (``chip_smoke.py`` passes the
    plain version to hold the kernels against it)."""
    if num_assets < 1:
        raise ConfigError(f"num_assets must be >= 1, got {num_assets}")
    window = (obs_dim - 1 - num_assets) // num_assets
    if num_assets * window + 1 + num_assets != obs_dim:
        raise ConfigError(
            f"obs_dim={obs_dim} does not match the {num_assets}-asset "
            f"portfolio layout (A*window + 1 + A)")
    device = resolve_device(device)
    block_len = window + 1
    seq_len = num_assets * block_len
    d_model = num_heads * head_dim
    attend = attention_fn or (
        lambda q, k, v: flash_attention(q, k, v, causal=True))

    def init(gen: torch.Generator) -> dict:
        """Fresh fp32 parameters drawn from ``gen`` on the CPU, moved to
        ``device``: the JAX tree and scales, not its numbers."""
        def ln():
            return {"scale": torch.ones(d_model, device=device),
                    "bias": torch.zeros(d_model, device=device)}

        params = {
            "embed": dense_init(gen, 3, d_model, device=device),
            "pos": (torch.randn((block_len, d_model), generator=gen)
                    * 0.02).to(device),
            "policy": dense_init(gen, d_model, num_actions, scale=0.01,
                                 device=device),
            "value": dense_init(gen, d_model, 1, device=device),
            "blocks": [],
            "final_ln": ln(),
        }
        out_scale = 0.02 / max(num_layers, 1)
        for _ in range(num_layers):
            block = {
                "ln1": ln(),
                "qkv": dense_init(gen, d_model, 3 * d_model, device=device),
                "proj": dense_init(gen, d_model, d_model, scale=out_scale,
                                   device=device),
                "ln2": ln(),
            }
            if moe_experts:
                from sharetrade_tpu_torch.parallel.moe import init_moe_params
                block["moe"] = init_moe_params(
                    gen, moe_experts, d_model, mlp_ratio * d_model,
                    device=device)
            else:
                block["mlp_in"] = dense_init(
                    gen, d_model, mlp_ratio * d_model, device=device)
                block["mlp_out"] = dense_init(
                    gen, mlp_ratio * d_model, d_model, scale=out_scale,
                    device=device)
            params["blocks"].append(block)
        if num_assets > 1:
            params["asset"] = (torch.randn((num_assets, d_model),
                                           generator=gen) * 0.02).to(device)
        return params

    def block_apply(blk, x):
        """One pre-LN block over (B, T, d) tokens; returns ``(x, aux)``."""
        bsz, t = x.shape[0], x.shape[1]
        dtype = compute_dtype(blk)
        h = layer_norm(x, blk["ln1"]["scale"], blk["ln1"]["bias"])
        qkv = dense(blk["qkv"], h).reshape(bsz, t, 3, num_heads, head_dim)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        attn = attend(q, k, v).transpose(1, 2).reshape(
            bsz, t, d_model).to(dtype)
        x = x + dense(blk["proj"], attn)
        h = layer_norm(x, blk["ln2"]["scale"], blk["ln2"]["bias"])
        y, aux = ffn_apply(blk, h, moe_experts=moe_experts,
                           moe_top_k=moe_top_k,
                           moe_capacity_factor=moe_capacity_factor)
        return x + y, aux

    def tokenize(obs):
        """(B, obs_dim) -> (B, seq, 3): per asset its tick features, then
        its portfolio token (budget, its shares, its window's last price)."""
        b = obs.shape[0]
        windows = obs[:, :num_assets * window].reshape(b, num_assets, window)
        budget = obs[:, num_assets * window]
        shares = obs[:, num_assets * window + 1:]                # (B, A)
        ticks = tick_window_features(
            windows.reshape(b * num_assets, window), window
        ).reshape(b, num_assets, window, 3)
        port = portfolio_features(budget[:, None].expand_as(shares), shares,
                                  windows[:, :, -1])             # (B, A, 3)
        return torch.cat([ticks, port[:, :, None, :]], dim=2).reshape(
            b, seq_len, 3)

    def apply_batch(params, obs, carry):
        """The whole batch through one attention call per layer, its grid
        batch x heads."""
        tokens = tokenize(obs).to(compute_dtype(params))
        x = dense(params["embed"], tokens) + params["pos"].repeat(
            num_assets, 1)
        if num_assets > 1:
            x = x + params["asset"].repeat_interleave(block_len, dim=0)
        aux = torch.zeros((), dtype=torch.float32, device=obs.device)
        for blk in params["blocks"]:
            x, blk_aux = block_apply(blk, x)
            aux = aux + blk_aux
        # The mean over the A portfolio tokens (A = 1: the last token).
        summary = layer_norm(x[:, window::block_len].mean(dim=1),
                             params["final_ln"]["scale"],
                             params["final_ln"]["bias"])
        logits = dense(params["policy"], summary).float()
        value = dense(params["value"], summary).float()[:, 0]
        return ModelOut(logits=logits, value=value,
                        aux=aux / max(num_layers, 1)), carry

    return Model(init=init, init_carry=dict, apply_batch=apply_batch,
                 obs_dim=obs_dim, name="transformer", device=device,
                 num_actions=num_actions)
