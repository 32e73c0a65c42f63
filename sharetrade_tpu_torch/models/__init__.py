"""Policy networks.

Counterpart of the JAX package's ``models/__init__.py``. Ported so far: the
MLPs (``model.kind="mlp"``: the reference Q-network ``q_mlp`` for
``head="q"``, ``ac_mlp`` for ``head="ac"``) and the episode-mode
transformer. Every other model kind, and every option of the episode
transformer that changes its function or its layout (mixture of experts,
pipelined blocks, sequence-parallel attention, block rematerialisation), is
refused with a ``ConfigError`` instead of being served as something else.
"""

from __future__ import annotations

import torch

from sharetrade_tpu_torch.config import ConfigError, ModelConfig
from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.models.core import Model, ModelOut  # noqa: F401


def build_model(cfg: ModelConfig, obs_dim: int, *, head: str = "ac",
                parity: bool = False,
                device: torch.device | str | None = None,
                attention_fn=None) -> Model:
    """Construct the policy network for ``cfg`` on ``device`` (``cuda``
    when None; raises without one). ``head="q"`` selects the Q-value head
    (MLP only: the reference network, with its constant biases and output
    ReLU under ``parity=True``), ``head="ac"`` the actor-critic heads.
    ``attention_fn`` replaces the banded flash attention of the prefill (see
    ``transformer_episode.episode_transformer_policy``)."""
    device = resolve_device(device)
    if cfg.dtype != "float32":
        raise ConfigError(f"model.dtype must be 'float32' (master weights; "
                          f"low precision is precision.mode's job), got "
                          f"{cfg.dtype!r}")
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
            return q_mlp(obs_dim, cfg.hidden_dim, cfg.num_actions,
                         parity=parity, device=device)
        return ac_mlp(obs_dim, cfg.hidden_dim, cfg.num_actions, device=device)
    if cfg.kind != "transformer" or cfg.seq_mode != "episode":
        raise ConfigError(
            f"model.kind={cfg.kind!r} with seq_mode={cfg.seq_mode!r} is not "
            "yet ported to sharetrade_tpu_torch; model.kind='mlp', and "
            "model.kind='transformer' with model.seq_mode='episode', are")
    unported = {
        "moe_experts": cfg.moe_experts != 0,
        "pipeline_blocks": bool(cfg.pipeline_blocks),
        "attention": cfg.attention != "flash",
        "remat_blocks": bool(cfg.remat_blocks),
    }
    for knob, set_ in unported.items():
        if set_:
            raise ConfigError(f"model.{knob}={getattr(cfg, knob)!r} is not "
                              "yet ported to sharetrade_tpu_torch")
    from sharetrade_tpu_torch.models.transformer_episode import (
        episode_transformer_policy)
    return episode_transformer_policy(
        obs_dim, cfg.num_actions, num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        head_dim=cfg.head_dim, device=device, attention_fn=attention_fn)
