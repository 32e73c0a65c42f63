"""Analytic model-FLOPs accounting and MFU.

Counterpart of the JAX package's ``utils/flops.py``: the same counting
rules and the same arithmetic, so a configuration's model FLOPs per
agent-step are the same number in both packages.

Counting rules (standard MFU conventions):

- A dense layer in->out over N rows costs 2*N*in*out FLOPs.
- Causal attention is counted at its useful cost, about half the full score
  matrix: 2*seq^2*d per attention matmul pair member (the kernels skip
  fully masked tiles).
- A backward pass costs 2x the forward it differentiates. Recompute under
  ``learner.remat`` or ``model.remat_blocks`` is not model work and is not
  counted, so MFU prices it as lost time.
- Env-step arithmetic, optimizer updates, layer norms and softmaxes are
  ignored (orders of magnitude below the matmuls).

Peaks are the card's data-sheet figures (NVIDIA H100 data sheet, dense,
no sparsity), keyed by ``torch.cuda.get_device_name()``: dense bf16 matmul
FLOP/s, the rate the port's bf16 paths run at, and HBM bytes/s. The JAX
module falls back to a TPU peak for a device it does not know; this one
raises for any other card and for the CPU, so an MFU is never stated
against a peak that is not the card's.
"""

from __future__ import annotations

import torch

from sharetrade_tpu_torch.config import (
    FrameworkConfig, LearnerConfig, ModelConfig)

#: Device-name substrings -> (dense bf16 peak FLOP/s, HBM bytes/s): the
#: H100 SXM (80 GB HBM3, 700 W) and the H100 PCIe, at their full power
#: limits.
_PEAKS = (
    ("H100 80GB HBM3", (989e12, 3.35e12)),
    ("H100 PCIe", (756e12, 2.0e12)),
)


def device_name(device=None) -> str:
    """``torch.cuda.get_device_name`` of ``device`` (the current CUDA
    device when None); a ``ValueError`` for the CPU or without a card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise ValueError(f"no peak rate for device {str(device)!r}: MFU is "
                         "stated against a CUDA card's peak only")
    return torch.cuda.get_device_name(device)


def peaks_for_name(name: str) -> tuple[float, float]:
    """``(peak bf16 FLOP/s, peak HBM bytes/s)`` of the card named ``name``;
    a ``ValueError`` for a card not in the table."""
    for sub, peaks in _PEAKS:
        if sub in name:
            return peaks
    raise ValueError(f"no data-sheet peak for card {name!r}; known: "
                     f"{[sub for sub, _ in _PEAKS]}")


def chip_peak_flops(device=None, *, name: str | None = None) -> float:
    """Dense bf16 peak FLOP/s of the card (``name`` overrides the lookup
    of ``device``'s name)."""
    return peaks_for_name(name or device_name(device))[0]


def chip_peak_hbm_bw(device=None, *, name: str | None = None) -> float:
    """Peak HBM bytes/s of the card (``name`` as in
    :func:`chip_peak_flops`)."""
    return peaks_for_name(name or device_name(device))[1]


def forward_flops_per_obs(model: ModelConfig, obs_dim: int,
                          algo: str = "qlearn") -> float:
    """Matmul FLOPs for ONE observation's policy forward pass.

    The MLP family has two architectures (``models/mlp.py``): value-based
    algos (qlearn/dqn) use ``q_mlp`` (obs->h->acts, no value head), and
    pg/a2c/ppo use ``ac_mlp`` (obs->h, h->h torso, policy and value
    heads)."""
    acts = model.num_actions
    if model.kind == "mlp":
        h = model.hidden_dim
        if algo in ("qlearn", "dqn"):
            return 2.0 * h * (obs_dim + acts)           # q_mlp: two denses
        return 2.0 * h * (obs_dim + h + acts + 1)       # ac_mlp: torso2 + heads
    if model.kind == "lstm":
        # models/lstm.py: obs->h input dense, fused [x;h]->4h gate matmul
        # (16*h^2), then policy + value heads.
        h = model.hidden_dim
        return 2.0 * h * obs_dim + 16.0 * h * h + 2.0 * h * (acts + 1)
    if model.kind == "tcn":
        # models/tcn.py: per block a K-tap dilated conv (2*W*K*C^2) plus a
        # 1x1 mix (2*W*C^2); the block count covers the window.
        from sharetrade_tpu_torch.models.tcn import KERNEL, default_num_blocks
        w = obs_dim - 2
        c = model.hidden_dim
        per_block = 2.0 * w * KERNEL * c * c + 2.0 * w * c * c
        return (default_num_blocks(w) * per_block
                + 2.0 * w * 3 * c + 2.0 * c * (acts + 1 + 3))
    if model.kind == "transformer":
        seq = obs_dim - 1                               # window + summary token
        d = model.num_heads * model.head_dim
        ffn = 16.0 * seq * d * d                        # MLP in/out at ratio 4
        if model.moe_experts:
            # Dense-mask MoE evaluates every expert on every token (E x the
            # dense FFN); top-k dispatch about k experts a token (drops make
            # this a slight overcount; dispatch and combine are routing).
            ffn *= (model.moe_top_k if model.moe_top_k else model.moe_experts)
        per_layer = (
            6.0 * seq * d * d        # qkv projection
            + 2.0 * seq * seq * d    # causal QK^T + PV (useful half of 4*s^2*d)
            + 2.0 * seq * d * d      # output projection
            + ffn
        )
        return model.num_layers * per_layer + 2.0 * seq * 3 * d  # + embed
    raise ValueError(f"unknown model kind {model.kind!r}")


def forward_equivalents_per_agent_step(cfg: LearnerConfig,
                                       num_agents: int) -> float:
    """How many single-observation forward passes one agent-step of
    training costs under each algorithm (backward = 2x the differentiated
    forward)."""
    if cfg.algo == "qlearn":
        # select fwd + stacked TD fwd over (s, s') + backward of the stack.
        return 1.0 + 2.0 + 2.0 * 2.0
    if cfg.algo in ("pg", "a2c"):
        return 1.0 + 1.0 + 2.0        # rollout fwd + replay fwd + backward
    if cfg.algo == "ppo":
        # rollout fwd + ppo_epochs x (replay fwd + backward).
        return 1.0 + cfg.ppo_epochs * 3.0
    if cfg.algo == "dqn":
        # select fwd; per env-step the learner trains on replay_batch
        # observations (online fwd + target fwd + backward), amortized over
        # the agent batch.
        per_replay = (cfg.replay_batch / max(num_agents, 1))
        return 1.0 + per_replay * (1.0 + 1.0 + 2.0)
    raise ValueError(f"unknown algo {cfg.algo!r}")


def _episode_mode_flops_per_agent_step(cfg: FrameworkConfig,
                                       obs_dim: int) -> float:
    """The episode-mode transformer, counting the FLOPs executed: the
    banded trunk runs for ONE representative row and amortizes over the B
    agents, in the rollout (``(S+1)/T`` tokens / B) and in every replay
    pass (epochs x minibatches x 3 (fwd + bwd) x ``S/T`` tokens / B, the
    shared replay); the heads are factored, their d-sized projections run
    once over the trunk rows and a 3-wide portfolio term per agent-step."""
    model, learner = cfg.model, cfg.learner
    w = obs_dim - 2
    d = model.num_heads * model.head_dim
    per_token = (model.num_layers * (24.0 * d * d + 4.0 * w * d)
                 + 2.0 * 3 * d        # tick embed
                 + 2.0 * d * (model.num_actions + 1 + 3))  # heads + port
    t = max(learner.unroll_len, 1)
    b = max(cfg.parallel.num_workers, 1)
    s = model.num_layers * (w - 1) + t
    if learner.algo == "ppo":
        epochs = learner.ppo_epochs
        # agents/ppo.py's divisor fallback: the largest divisor of the
        # agent count not above the requested minibatch count.
        requested = max(1, min(learner.ppo_minibatches, b))
        mb_count = max(d for d in range(1, requested + 1) if b % d == 0)
        passes = epochs * mb_count
    else:
        epochs, passes = 1, 1
    head_base = 2.0 * d * (model.num_actions + 1) * (t + 1) / t / b
    head_pf_step = 2.0 * 3 * (model.num_actions + 1)
    replay_heads = (2.0 * d * (model.num_actions + 1) * passes * 3.0 / b
                    + head_pf_step * epochs * 3.0)
    return (per_token * (s + 1) / t / b           # rollout trunk (shared)
            + head_base + head_pf_step             # factored rollout head
            + per_token * passes * 3.0 * s / t / b  # replay trunks (shared)
            + replay_heads)                        # factored replay heads


def train_flops_per_agent_step(cfg: FrameworkConfig, obs_dim: int) -> float:
    """Model FLOPs of one agent-step of training under ``cfg``."""
    if (cfg.model.kind == "transformer" and cfg.model.seq_mode == "episode"
            and cfg.learner.algo in ("pg", "a2c", "ppo")):
        return _episode_mode_flops_per_agent_step(cfg, obs_dim)
    return (forward_flops_per_obs(cfg.model, obs_dim, cfg.learner.algo)
            * forward_equivalents_per_agent_step(
                cfg.learner, cfg.parallel.num_workers))


def mfu(agent_steps_per_sec: float, cfg: FrameworkConfig, obs_dim: int,
        device=None, *, name: str | None = None) -> float:
    """Model FLOPs utilization in [0, 1] against the card's bf16 peak
    (``device``'s, or the card named ``name``)."""
    achieved = agent_steps_per_sec * train_flops_per_agent_step(cfg, obs_dim)
    return achieved / chip_peak_flops(device, name=name)
