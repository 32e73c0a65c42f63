"""Recurrent (LSTM) actor-critic policy (BASELINE.json config 4).

Counterpart of the JAX package's ``models/lstm.py``. The cell computes its
four gates as one product ``[x ; h] @ W`` (2H x 4H), split into i, f, g, o,
with the forget gate biased by +1 (``sigmoid(f + 1.0)``); the input first
passes a ReLU dense layer. The carry is the tuple ``(h, c)``, as in the
JAX package; the JAX model's ``apply`` takes one session and is vmapped
over the batch, here ``apply_batch`` takes (B, H) carries natively.
Computes in the dtype of the parameters it is handed (the float32 masters
or the bf16 compute copy); the precision policy casts the carry with them
(``precision.cast_carry`` keeps the tuple).
"""

from __future__ import annotations

import torch

from sharetrade_tpu_torch.device import resolve_device
from sharetrade_tpu_torch.models.core import (Model, ModelOut, compute_dtype,
                                              dense, dense_init)


def lstm_policy(obs_dim: int = 203, hidden_dim: int = 200,
                num_actions: int = 3, *,
                device: torch.device | str | None = None) -> Model:
    device = resolve_device(device)

    def init(gen: torch.Generator) -> dict:
        return {
            "input": dense_init(gen, obs_dim, hidden_dim, device=device),
            "gates": dense_init(gen, 2 * hidden_dim, 4 * hidden_dim,
                                device=device),
            "policy": dense_init(gen, hidden_dim, num_actions, scale=0.01,
                                 device=device),
            "value": dense_init(gen, hidden_dim, 1, device=device),
        }

    def init_carry():
        zeros = torch.zeros((hidden_dim,), device=device)
        return (zeros, zeros)

    def apply_batch(params, obs, carry):
        h_prev, c_prev = carry
        x = torch.relu(dense(params["input"],
                             obs.to(compute_dtype(params))))
        gates = dense(params["gates"], torch.cat([x, h_prev], dim=-1))
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c_prev + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        logits = dense(params["policy"], h).float()
        value = dense(params["value"], h).float()[:, 0]
        return ModelOut(logits=logits, value=value), (h, c)

    return Model(init=init, init_carry=init_carry, apply_batch=apply_batch,
                 obs_dim=obs_dim, name="lstm", device=device,
                 num_actions=num_actions)
