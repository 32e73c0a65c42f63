"""sharetrade_tpu_torch — the PyTorch/CUDA port of ``sharetrade_tpu``.

The JAX package beside this one is the reference; this package computes the
same functions in PyTorch, with every Pallas kernel on its path rewritten by
hand for NVIDIA Hopper (``sm_90a``). It imports neither ``jax`` nor anything
of the JAX package: what it needs from modules there (the config schema, the
data types, the logging setup) it keeps as its own copies.

Ported so far — the serving path of the episode-mode transformer:

- ``config``        the whole config schema (copy)
- ``data``          price series types, CSV + synthetic providers
- ``env.trading``   action constants and the observation layout
- ``precision``     fp32 masters / bf16 compute policy
- ``models``        ``build_model`` for the episode transformer
- ``ops.attention`` banded causal flash attention; CUDA kernel ``flash_fwd``
- ``convert``       JAX params pytree (as numpy) <-> port params
- ``serve``         continuous-batching engine over a session slot arena
- ``cli``           ``python -m sharetrade_tpu_torch.cli serve``

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``); with no card and no such request they
raise. On a CPU tensor each kernel wrapper takes its plain PyTorch version.
"""

__version__ = "0.1.0"
