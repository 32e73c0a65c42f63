"""sharetrade_tpu_torch — the PyTorch/CUDA port of ``sharetrade_tpu``.

The JAX package beside this one is the reference; this package computes the
same functions in PyTorch, with every Pallas kernel on its path rewritten by
hand for NVIDIA Hopper (``sm_90a``). It imports neither ``jax`` nor anything
of the JAX package: what it needs from modules there (the config schema, the
data types, the logging setup) it keeps as its own copies.

Ported so far — the reference workload (the JAX package's defaults: the
203 -> 200 -> 3 Q-network trained by online Q-learning, and DQN, PG and A2C
on the MLPs), serving and PPO training of the episode-mode transformer, and
the training runtime's persistence and supervision:

- ``config``        the whole config schema (copy)
- ``data``          price series types, CSV + synthetic providers
- ``env``           the trading env (reset, observe, step, portfolio value)
- ``precision``     fp32 masters / bf16 compute policy
- ``models``        ``build_model``: the MLPs (Q-head and actor-critic) and
                    the episode transformer
- ``ops``           banded causal flash attention (CUDA ``flash_fwd``,
                    ``flash_bwd_dq``, ``flash_bwd_dkv``), the fused
                    optimizer update (CUDA ``fused_update``) and the PER
                    sum-tree (plain tensor code)
- ``agents``        Q-learning, DQN (uniform and prioritized replay), PG,
                    A2C and PPO; the per-step and precomputed-trunk
                    rollouts; the greedy replays; the chunk program (a
                    CUDA graph of one chunk on the card)
- ``runtime``       the supervised orchestrator: megachunks, sampled
                    readback and the async readback pipeline
- ``utils``         logging, the metrics registry and the step timer
- ``checkpoint``    atomic, checksummed, resumable checkpoints
- ``convert``       JAX params / training states (as numpy) <-> the port's
- ``serve``         continuous-batching engine over a session slot arena
- ``cli``           ``python -m sharetrade_tpu_torch.cli train|serve``

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); with no card and no such request they
raise. On a CPU tensor each kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
