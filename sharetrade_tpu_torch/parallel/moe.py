"""Mixture-of-experts FFN, single device.

Counterpart of the single-device part of the JAX package's
``parallel/moe.py`` (same function names, same arithmetic):

1. **Dense-mask top-1** (:func:`moe_apply`): every expert evaluates every
   token under the routing mask. Exact (no token dropping), O(E·N).
2. **Capacity-bucketed top-k** (:func:`moe_apply_topk`): tokens are routed
   in groups of ``group_size`` (the tail zero-padded) into per-expert
   buffers of C slots a group (:func:`_capacity`, a multiple of 8), claimed
   rank-major (every token's first pick before any token's second); picks
   past a full buffer are dropped. Which picks drop depends on the token
   order and the group boundaries, so callers keep the JAX package's row
   order (``agents/rollout.replay_forward`` folds batch-major).

Both return ``(output (N, d), aux)``, aux the switch-style load-balance
loss ``E · Σ_e importance_e · load_e``.

Matrix products accumulate in float32 and round once to the tokens' dtype,
as the JAX ``preferred_element_type=f32`` einsums do (a bf16 product in
PyTorch already does). The top-k choice breaks ties toward the lower
expert index, as ``jax.lax.top_k`` does: a stable sort of the negated
probabilities, not ``torch.topk``, whose order among equal values is not
specified.

Not ported: the ep-sharded ``_sharded`` forms and the token-sharded
``_a2a`` dispatch (multi-device; ``models.build_model`` refuses
``model.moe_dispatch="a2a"``).
"""

from __future__ import annotations

import torch


def init_moe_params(gen: torch.Generator, num_experts: int, in_dim: int,
                    hidden_dim: int, *,
                    device: torch.device | str = "cpu") -> dict:
    """The gate (std 0.01) and the expert bank (He-normal), drawn on the
    CPU from ``gen`` and moved to ``device``; the JAX tree and scales."""
    def normal(shape, std):
        return (torch.randn(shape, generator=gen) * std).to(device)

    return {
        "gate": normal((in_dim, num_experts), 0.01),
        "w_in": normal((num_experts, in_dim, hidden_dim),
                       (2.0 / in_dim) ** 0.5),
        "w_out": normal((num_experts, hidden_dim, in_dim),
                        (2.0 / hidden_dim) ** 0.5),
    }


def moe_apply(params: dict, tokens: torch.Tensor):
    """Top-1 MoE over (N, d) tokens, every expert evaluated densely under
    the mask. Returns ``(output (N, d), aux)``."""
    logits = tokens @ params["gate"]                         # (N, E)
    probs = torch.softmax(logits, dim=-1)
    num_experts = params["gate"].shape[-1]
    onehot = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), num_experts).to(tokens.dtype)
    weight = (probs * onehot).sum(dim=-1)                    # pick's gate
    h = torch.relu(torch.einsum("ni,eih->enh", tokens, params["w_in"]))
    y = torch.einsum("enh,ehi->eni", h, params["w_out"])
    out = torch.einsum("eni,ne->ni", y, onehot) * weight[:, None]
    aux = num_experts * (probs.mean(dim=0) * onehot.mean(dim=0)).sum()
    return out, aux


def _pad_groups(tokens: torch.Tensor, group_size: int | None):
    """(N, d) tokens -> ``(grouped (G, g, d), valid (G, g) 0/1 float32)``:
    one group of N when ``N <= group_size`` (or no size), else groups of
    ``group_size`` with the tail zero-padded."""
    n = tokens.shape[0]
    if group_size is None or n <= group_size:
        groups, g = 1, n
    else:
        g = group_size
        groups = -(-n // g)
    n_pad = groups * g
    toks = torch.nn.functional.pad(tokens, (0, 0, 0, n_pad - n))
    valid = (torch.arange(n_pad, device=tokens.device) < n).float()
    return toks.reshape(groups, g, -1), valid.reshape(groups, g)


def _capacity(group_tokens: int, num_experts: int, top_k: int,
              capacity_factor: float) -> int:
    """Per-expert buffer slots a group: ``ceil(k·g·factor / E)``, at least
    1, rounded up to a multiple of 8 (the JAX package's sublane rounding;
    it decides which picks drop, so it is kept)."""
    cap = -(-top_k * group_tokens * capacity_factor // num_experts)
    cap = max(int(cap), 1)
    return -(-cap // 8) * 8


def _topk_route(gate_logits: torch.Tensor, top_k: int, capacity: int, dtype,
                valid: torch.Tensor | None = None):
    """Top-k routing with per-expert capacity, per group: (G, g, E) logits
    -> ``(dispatch (G, g, E, C), combine (G, g, E, C), (importance,
    load))``. ``valid`` (G, g) marks real rows: padding claims no slot and
    stays out of the balance statistics."""
    groups, g, num_experts = gate_logits.shape
    probs = torch.softmax(gate_logits, dim=-1)
    order = torch.sort(-probs, dim=-1, stable=True).indices[..., :top_k]
    top_p = probs.gather(-1, order)                          # (G, g, k)
    sel = torch.nn.functional.one_hot(order, num_experts).float()
    if valid is not None:
        sel = sel * valid[:, :, None, None]

    # Slot of each pick: earlier claims on its expert, counted rank-major.
    sel_rank_major = sel.transpose(1, 2).reshape(groups, top_k * g,
                                                 num_experts)
    pos = torch.cumsum(sel_rank_major, dim=1) - sel_rank_major
    pos = pos.reshape(groups, top_k, g, num_experts).transpose(1, 2)
    pos_of_pick = (pos * sel).sum(dim=-1).to(torch.int32)   # (G, g, k)

    keep = (pos_of_pick < capacity).float()
    # one_hot of a slot past the buffer is all zero (as jax.nn.one_hot).
    slot = (pos_of_pick[..., None] == torch.arange(
        capacity, device=pos_of_pick.device)).float()       # (G, g, k, C)
    dispatch = torch.einsum("Gnke,Gnkc->Gnec", keep[..., None] * sel, slot)
    combine = torch.einsum("Gnke,Gnkc->Gnec",
                           (keep * top_p)[..., None] * sel, slot)

    if valid is None:
        importance = probs.mean(dim=(0, 1))
        load = sel[:, :, 0, :].mean(dim=(0, 1))
    else:
        denom = torch.clamp(valid.sum(), min=1.0)
        importance = (probs * valid[:, :, None]).sum(dim=(0, 1)) / denom
        load = sel[:, :, 0, :].sum(dim=(0, 1)) / denom
    return dispatch.to(dtype), combine.to(dtype), (importance, load)


def _balance_loss(importance: torch.Tensor,
                  load: torch.Tensor) -> torch.Tensor:
    """``E · Σ_e importance_e · load_e``."""
    return importance.shape[-1] * (importance * load).sum()


def _expert_ffn(w_in: torch.Tensor, w_out: torch.Tensor,
                xs: torch.Tensor) -> torch.Tensor:
    """relu FFN over per-expert buffers: (E, C, d) -> (E, C, d)."""
    h = torch.relu(torch.einsum("eci,eih->ech", xs, w_in))
    return torch.einsum("ech,ehi->eci", h, w_out)


def _dispatch_gather(dispatch: torch.Tensor,
                     toks: torch.Tensor) -> torch.Tensor:
    """(G, g, E, C) dispatch x (G, g, d) tokens -> (E, G·C, d) buffers."""
    groups, _, num_experts, cap = dispatch.shape
    xs = torch.einsum("Gnec,Gni->Geci", dispatch, toks)
    return xs.transpose(0, 1).reshape(num_experts, groups * cap, -1)


def _combine_scatter(combine: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
    """(E, G·C, d) expert outputs x (G, g, E, C) combine -> (G·g, d)."""
    groups, g, num_experts, cap = combine.shape
    ys = ys.reshape(num_experts, groups, cap, -1).transpose(0, 1)
    out = torch.einsum("Geci,Gnec->Gni", ys, combine)
    return out.reshape(groups * g, -1)


def moe_apply_topk(params: dict, tokens: torch.Tensor, *, top_k: int = 2,
                   capacity_factor: float = 1.25,
                   group_size: int | None = 1024):
    """Top-k MoE with capacity-bucketed dispatch over (N, d) tokens: each
    expert evaluates only its routed buffer; overflowing picks contribute
    zero. Returns ``(output (N, d), aux)``."""
    n = tokens.shape[0]
    num_experts = params["gate"].shape[-1]
    toks, valid = _pad_groups(tokens, group_size)
    cap = _capacity(toks.shape[1], num_experts, top_k, capacity_factor)
    dispatch, combine, (importance, load) = _topk_route(
        torch.einsum("Gni,ie->Gne", toks, params["gate"]), top_k, cap,
        tokens.dtype, valid)
    ys = _expert_ffn(params["w_in"], params["w_out"],
                     _dispatch_gather(dispatch, toks))
    return _combine_scatter(combine, ys)[:n], _balance_loss(importance, load)
