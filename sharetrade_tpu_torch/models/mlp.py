"""MLP policy networks.

Counterpart of the JAX package's ``models/mlp.py``. ``q_mlp`` is the
reference system's Q-network (QDecisionPolicyActor.scala:38-50):

    h1 = relu(x @ w1 + 0.1)      w1: (203, 200), RandomNormal init
    q  = relu(h1 @ w2 + 0.1)     w2: (200, 3),   RandomNormal init

``parity=True`` keeps both of its oddities: constant (untrained) 0.1 biases
and the ReLU on the output, with stddev-1 normal weights. ``parity=False``
(what ``build_model`` gives unless asked) is the conventional variant:
He-normal weights, trained zero-initialised biases, unclamped Q-values.

``ac_mlp`` is the actor-critic form (a two-layer torso, a policy head of
std 0.01 and a value head) that PG and A2C train.

Both hold no recurrent state: ``init_carry()`` is ``{}``. Each gives
``apply_batch(params, obs (B, obs_dim), carry) -> (ModelOut, carry)``,
computing in the dtype of the parameters it is handed (the float32 masters
or the bf16 compute copy), and returns float32 logits and values. The
weights are drawn on the CPU from the generator ``init`` is given, in the
order of the parameter tree, and then moved to the model's device.
"""

from __future__ import annotations

import torch

from sharetrade_tpu_torch.models.core import (Model, ModelOut, compute_dtype,
                                              dense, dense_init)


def q_mlp(obs_dim: int = 203, hidden_dim: int = 200, num_actions: int = 3,
          *, parity: bool = True,
          device: torch.device | str = "cpu") -> Model:
    """The reference Q-network; ``value`` is 0 (a Q-head has no critic)."""
    scale = 1.0 if parity else None

    def init(gen: torch.Generator):
        p1 = dense_init(gen, obs_dim, hidden_dim, scale=scale, device=device)
        p2 = dense_init(gen, hidden_dim, num_actions, scale=scale,
                        device=device)
        if parity:
            # The reference's biases are tf.constant(0.1): not parameters.
            return {"layer1": {"w": p1["w"]}, "layer2": {"w": p2["w"]}}
        return {"layer1": p1, "layer2": p2}

    def apply_batch(params, obs, carry):
        x = obs.to(compute_dtype(params))
        if parity:
            h = torch.relu(torch.matmul(x, params["layer1"]["w"]) + 0.1)
            q = torch.relu(torch.matmul(h, params["layer2"]["w"]) + 0.1)
        else:
            h = torch.relu(dense(params["layer1"], x))
            q = dense(params["layer2"], h)
        value = torch.zeros(q.shape[:-1], dtype=torch.float32,
                            device=q.device)
        return ModelOut(logits=q.float(), value=value), carry

    return Model(init=init, init_carry=dict, apply_batch=apply_batch,
                 obs_dim=obs_dim, name="q_mlp", device=torch.device(device),
                 num_actions=num_actions)


def ac_mlp(obs_dim: int = 203, hidden_dim: int = 200, num_actions: int = 3,
           *, device: torch.device | str = "cpu") -> Model:
    """Two-layer torso with separate policy and value heads."""

    def init(gen: torch.Generator):
        return {
            "torso1": dense_init(gen, obs_dim, hidden_dim, device=device),
            "torso2": dense_init(gen, hidden_dim, hidden_dim, device=device),
            "policy": dense_init(gen, hidden_dim, num_actions, scale=0.01,
                                 device=device),
            "value": dense_init(gen, hidden_dim, 1, device=device),
        }

    def apply_batch(params, obs, carry):
        x = obs.to(compute_dtype(params))
        h = torch.relu(dense(params["torso1"], x))
        h = torch.relu(dense(params["torso2"], h))
        logits = dense(params["policy"], h).float()
        value = dense(params["value"], h).float()[..., 0]
        return ModelOut(logits=logits, value=value), carry

    return Model(init=init, init_carry=dict, apply_batch=apply_batch,
                 obs_dim=obs_dim, name="ac_mlp", device=torch.device(device),
                 num_actions=num_actions)
