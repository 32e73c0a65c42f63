"""Model interface and the small numeric helpers every policy shares.

Counterpart of the JAX package's ``models/core.py``. A model is a bundle of
plain functions over a parameter tree — nested ``dict``/``list`` of tensors
laid out exactly like the JAX pytree — so weights convert leaf for leaf
(``convert.py``) and both packages can be fed the same numbers.

Dense weights keep the JAX layout ``w: (in, out)``; ``dense`` computes
``x @ w``. (``torch.nn.Linear`` would store ``(out, in)``; the port does not
use it, so no transpose happens anywhere.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

_EPS = 1e-6


class ModelOut(NamedTuple):
    logits: torch.Tensor   # (B, num_actions) float32
    value: torch.Tensor    # (B,) float32


@dataclass(frozen=True)
class Model:
    """A policy network as a bundle of functions (stateless module).

    ``init(generator) -> params`` on ``device``; ``init_carry() -> carry`` for one
    session; the serving pair ``apply_prefill(params, obs (B, obs_dim)) ->
    (ModelOut, carry_batch)`` for a batch of fresh sessions and
    ``apply_serve_batch(params, obs, carry_batch) -> (ModelOut,
    carry_batch)`` for a batch of warm sessions at heterogeneous episode
    steps; ``cast_carry(carry, dtype)`` is the precision policy's hook.

    The training entries, with the JAX package's signatures (its
    ``models/core.py`` field docs):

    - ``apply_unroll(params, obs (T, B, obs_dim), carry) -> (logits (T, B,
      A), values (T, B), aux)``: the replay as one banded pass;
    - ``apply_unroll_shared``: the same outputs, the banded pass run once
      for a representative row and only the head per agent;
    - ``apply_rollout_trunk(params, obs (B, obs_dim), future_ticks (B, T),
      carry) -> (hn_base (B, T+1, d), carry after T steps)``;
    - ``apply_rollout_head(params, hn_row (B, d), obs) -> ModelOut``;
    - ``rollout_head_factored(params, hn_base (T+1, d)) -> (base_logits,
      base_values, pf_fn)`` with ``pf_fn(obs) -> (dlogits, dvalues)``."""

    init: Callable[..., Any]
    init_carry: Callable[[], Any]
    apply_prefill: Callable[[Any, torch.Tensor], tuple[ModelOut, Any]]
    apply_serve_batch: Callable[[Any, torch.Tensor, Any],
                                tuple[ModelOut, Any]]
    cast_carry: Callable[[Any, torch.dtype], Any] | None = None
    obs_dim: int = 0
    name: str = "model"
    device: torch.device = torch.device("cpu")
    num_actions: int = 3
    apply_unroll: Callable | None = None
    apply_unroll_shared: Callable | None = None
    apply_rollout_trunk: Callable | None = None
    apply_rollout_head: Callable | None = None
    rollout_head_factored: Callable | None = None


def compute_dtype(params: Any) -> torch.dtype:
    """The dtype a forward computes in: that of the first floating tensor
    of the parameters it was handed (fp32 masters or the bf16 copy)."""
    def first_float(tree):
        if isinstance(tree, torch.Tensor):
            return tree.dtype if tree.is_floating_point() else None
        items = tree.values() if isinstance(tree, dict) else tree
        for leaf in items:
            found = first_float(leaf)
            if found is not None:
                return found
        return None

    return first_float(params) or torch.float32


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested dict/list/tuple tree, dict keys in sorted
    order (as ``jax.tree.leaves`` orders them), so two trees of the same
    structure pair up leaf for leaf whatever their key insertion order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    """``fn`` applied to every leaf of a nested dict/list/tuple tree, in
    :func:`tree_leaves` order (tuples come back as lists)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def unflatten_like(tree: Any, leaves: list) -> Any:
    """A tree shaped like ``tree`` whose leaves are ``leaves`` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def rows_finite(tree: Any, batch: int) -> torch.Tensor:
    """(batch,) bool: True where every batched leaf row of ``tree`` is
    finite — the row predicate shared by the rollout's representative
    election (agents/base.election_health) and the shared replay's.
    Leaves whose leading dim is not ``batch`` are ignored; integer leaves
    pass."""
    ok = None
    for leaf in tree_leaves(tree):
        if not isinstance(leaf, torch.Tensor) or leaf.ndim < 1 \
                or leaf.shape[0] != batch:
            continue
        if ok is None:
            ok = torch.ones((batch,), dtype=torch.bool, device=leaf.device)
        if leaf.is_floating_point():
            ok = ok & torch.isfinite(leaf).reshape(batch, -1).all(dim=-1)
    if ok is None:
        raise ValueError(f"rows_finite: no leaf has leading dim {batch}")
    return ok


def dense(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated in float32 and rounded once to ``x``'s dtype,
    then ``+ b`` in that dtype — the JAX package's
    ``dot(preferred_element_type=f32).astype(x.dtype) + b``. A bf16 product
    in PyTorch already accumulates in float32 and rounds its output once."""
    return torch.matmul(x, p["w"]) + p["b"]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Pre-LN normalisation computed in the activation dtype (the JAX
    window/episode transformers' ``_layer_norm``): population variance."""
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def portfolio_features(budget: torch.Tensor, shares: torch.Tensor,
                       anchor: torch.Tensor) -> torch.Tensor:
    """(...,) scalars -> (..., 3) normalised portfolio features; ``anchor``
    is the window's newest price."""
    anchor = torch.clamp(anchor, min=_EPS)
    return torch.stack([budget / (anchor * 100.0), shares / 100.0,
                        torch.ones_like(budget)], dim=-1)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               scale: float | None = None,
               device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """He-normal weights (std sqrt(2/in)) unless ``scale`` overrides the
    std; zero bias. Drawn on the CPU from ``gen`` so a seed gives the same
    weights on every device."""
    std = (2.0 / in_dim) ** 0.5 if scale is None else scale
    w = torch.randn((in_dim, out_dim), generator=gen,
                    dtype=torch.float32) * std
    return {"w": w.to(device), "b": torch.zeros((out_dim,), device=device)}
