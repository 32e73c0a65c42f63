"""Policy networks.

Counterpart of the JAX package's ``models/__init__.py``. Only the
episode-mode transformer is ported so far; every other model kind, and every
option of the episode transformer that changes its function or its layout
(mixture of experts, pipelined blocks, sequence-parallel attention, block
rematerialisation), is refused with a ``ConfigError`` instead of being
served as something else.
"""

from __future__ import annotations

import torch

from sharetrade_tpu_torch.config import ConfigError, ModelConfig
from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.models.core import Model, ModelOut  # noqa: F401


def build_model(cfg: ModelConfig, obs_dim: int, *,
                device: torch.device | str | None = None,
                attention_fn=None) -> Model:
    """Construct the policy network for ``cfg`` on ``device`` (``cuda``
    when None; raises without one). ``attention_fn`` replaces the banded
    flash attention of the prefill (see
    ``transformer_episode.episode_transformer_policy``)."""
    device = resolve_device(device)
    if cfg.dtype != "float32":
        raise ConfigError(f"model.dtype must be 'float32' (master weights; "
                          f"low precision is precision.mode's job), got "
                          f"{cfg.dtype!r}")
    if cfg.kind != "transformer" or cfg.seq_mode != "episode":
        raise ConfigError(
            f"model.kind={cfg.kind!r} with seq_mode={cfg.seq_mode!r} is not "
            "yet ported to sharetrade_tpu_torch; only model.kind="
            "'transformer' with model.seq_mode='episode' is")
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
