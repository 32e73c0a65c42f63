"""Policy networks.

Counterpart of the JAX package's ``models/__init__.py``: the model zoo
behind one ``build_model``, keyed by ``model.kind`` — the MLPs (``q_mlp``
for ``head="q"``, ``ac_mlp`` for ``head="ac"``), the LSTM, the TCN, and the
transformer in window mode (dense or mixture-of-experts FFN, single- or
multi-asset) and in episode mode.

Refused with a ``ConfigError``, as the JAX package refuses them without a
mesh or the port has not ported them: ring / ulysses attention, pipelined
blocks, the all_to_all MoE dispatch (they need a mesh); the episode
transformer's mixture of experts and block rematerialisation; the TCN and
the episode transformer over more than one asset.
"""

from __future__ import annotations

import torch

from sharetrade_tpu_torch.config import ConfigError, ModelConfig
from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.models.core import Model, ModelOut  # noqa: F401


def _validate_moe_dispatch(cfg: ModelConfig) -> None:
    """The JAX ``_validate_moe_dispatch`` with no mesh: an all_to_all
    dispatch needs one."""
    if cfg.moe_dispatch not in ("psum", "a2a"):
        raise ConfigError(
            f"unknown model.moe_dispatch {cfg.moe_dispatch!r} "
            "(expected 'psum' or 'a2a')")
    if cfg.moe_dispatch == "a2a" and cfg.moe_experts:
        if not cfg.moe_top_k:
            raise ConfigError(
                "model.moe_dispatch='a2a' is a top-k dispatch pattern; "
                "set model.moe_top_k>0")
        raise ConfigError(
            "model.moe_dispatch='a2a' needs a mesh with an 'ep' axis; "
            "multi-device layouts are not yet ported to sharetrade_tpu_torch")


def build_model(cfg: ModelConfig, obs_dim: int, *, head: str = "ac",
                parity: bool = False,
                device: torch.device | str | None = None,
                attention_fn=None, num_actions: int | None = None,
                num_assets: int = 1) -> Model:
    """Construct the policy network for ``cfg`` on ``device`` (``cuda``
    when None; raises without one). ``head="q"`` selects the Q-value head
    (MLP only: the reference network, with its constant biases and output
    ReLU under ``parity=True``), ``head="ac"`` the actor-critic heads.
    ``num_actions`` overrides the config's (a multi-asset env widens the
    head); ``num_assets`` > 1 selects the window transformer's per-asset
    tokenization of the portfolio observation. ``attention_fn`` replaces
    the transformers' flash attention (see their policy builders)."""
    device = resolve_device(device)
    if cfg.dtype != "float32":
        raise ConfigError(f"model.dtype must be 'float32' (master weights; "
                          f"low precision is precision.mode's job), got "
                          f"{cfg.dtype!r}")
    actions = cfg.num_actions if num_actions is None else num_actions
    if cfg.seq_mode not in ("window", "episode"):
        raise ConfigError(f"unknown model.seq_mode {cfg.seq_mode!r}")
    if cfg.seq_mode == "episode" and cfg.kind != "transformer":
        raise ConfigError(
            f"model.seq_mode='episode' is a transformer mode; "
            f"model.kind={cfg.kind!r} would silently ignore it")
    if cfg.remat_blocks and not (cfg.kind == "transformer"
                                 and cfg.seq_mode == "episode"):
        raise ConfigError(
            "model.remat_blocks applies to the episode-mode transformer's "
            "banded replay only; other models would silently ignore it")
    if cfg.kind == "mlp":
        from sharetrade_tpu_torch.models.mlp import ac_mlp, q_mlp
        if head == "q":
            return q_mlp(obs_dim, cfg.hidden_dim, actions, parity=parity,
                         device=device)
        return ac_mlp(obs_dim, cfg.hidden_dim, actions, device=device)
    if cfg.kind == "lstm":
        from sharetrade_tpu_torch.models.lstm import lstm_policy
        return lstm_policy(obs_dim, cfg.hidden_dim, actions, device=device)
    if cfg.kind == "tcn":
        if num_assets > 1:
            raise ConfigError(
                "model.kind='tcn' is single-asset (PARITY.md); use the "
                "window transformer, mlp, or lstm for multi-asset "
                "portfolios")
        from sharetrade_tpu_torch.models.tcn import tcn_policy
        return tcn_policy(obs_dim, actions, channels=cfg.hidden_dim,
                          device=device)
    if cfg.kind != "transformer":
        raise ConfigError(f"unknown model kind {cfg.kind!r}")
    if cfg.attention in ("ring", "ulysses") or cfg.pipeline_blocks:
        knob = ("pipeline_blocks" if cfg.pipeline_blocks else "attention")
        raise ConfigError(
            f"model.{knob}={getattr(cfg, knob)!r} needs a mesh; multi-device "
            "layouts are not yet ported to sharetrade_tpu_torch")
    if cfg.attention != "flash":
        raise ConfigError(f"unknown model.attention {cfg.attention!r}")
    _validate_moe_dispatch(cfg)
    if cfg.seq_mode == "episode":
        if num_assets > 1:
            raise ConfigError(
                "model.seq_mode='episode' is single-asset (PARITY.md); use "
                "seq_mode='window' for multi-asset portfolios")
        for knob in ("moe_experts", "remat_blocks"):
            if getattr(cfg, knob):
                raise ConfigError(
                    f"model.{knob}={getattr(cfg, knob)!r} with "
                    "seq_mode='episode' is not yet ported to "
                    "sharetrade_tpu_torch")
        from sharetrade_tpu_torch.models.transformer_episode import (
            episode_transformer_policy)
        return episode_transformer_policy(
            obs_dim, actions, num_layers=cfg.num_layers,
            num_heads=cfg.num_heads, head_dim=cfg.head_dim, device=device,
            attention_fn=attention_fn)
    from sharetrade_tpu_torch.models.transformer import transformer_policy
    return transformer_policy(
        obs_dim, actions, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        head_dim=cfg.head_dim, device=device, attention_fn=attention_fn,
        moe_experts=cfg.moe_experts, moe_top_k=cfg.moe_top_k,
        moe_capacity_factor=cfg.moe_capacity_factor, num_assets=num_assets)
