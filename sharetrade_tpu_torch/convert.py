"""Carry weights between the JAX package and the port.

A JAX params pytree, with its leaves turned into numpy arrays (for example
``jax.tree.map(np.asarray, params)``), is a nested ``dict``/``list`` of
arrays. The port's parameters are the same tree with ``torch.Tensor`` leaves:

    embed/port/policy/value   {"w": (in, out), "b": (out,)}
    final_ln                  {"scale": (d,), "bias": (d,)}
    blocks[i]                 {"ln1", "qkv", "proj", "ln2", "mlp_in",
                               "mlp_out"} with the same leaves

Dense weights keep the JAX ``(in, out)`` layout: the port multiplies
``x @ w`` (``models.core.dense``) and does not use ``torch.nn.Linear``,
whose ``(out, in)`` layout would need a transpose here. So the conversion
copies every leaf as it is, dtype included, and the round trip
``params_to_numpy(params_from_jax(tree))`` is bitwise.

For files, :func:`flatten` names each leaf by its dotted path
(``blocks.0.qkv.w``) — the layout ``--params`` reads from an ``.npz``.

A whole training state carries over the same way
(:func:`train_state_from_jax` / :func:`train_state_to_numpy`): params; the
optax state, a ``(ScaleByRssState | ScaleByAdamState | EmptyState,
EmptyState)`` tuple that becomes the port's NamedTuples of the same field
names (``ops/fused_update.py``); the batched env state
(``t, budget, shares, share_value``); the model carry; ``env_steps`` and
``updates``. Every leaf keeps its dtype and bytes, so the round trip is
bitwise. The JAX random key has no torch counterpart: the port's state gets
a fresh generator. :func:`save_train_state_npz` writes such a state as one
``.npz`` (``cli train --params`` boots from it).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from sharetrade_tpu_torch.ops.fused_update import (
    EmptyState, ScaleByAdamState, ScaleByRssState)

_ENV_FIELDS = ("t", "budget", "shares", "share_value")


def params_from_jax(tree: Any, *, device: torch.device | str = "cpu") -> Any:
    """JAX params pytree (numpy leaves) -> port parameters on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device=device) for v in tree]
    return _tensor(tree, device)


def _tensor(x, device) -> torch.Tensor:
    """A numpy leaf as a tensor on ``device``, dtype and bytes kept
    (bfloat16 arrays — ml_dtypes' — travel as their uint16 bits)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """A copy on the host (never a view of a live tensor, which the
    training step updates in place)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes   # numpy's bfloat16, as the JAX package's arrays
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Any) -> Any:
    """Port parameters -> the same tree with numpy leaves (on the host);
    numpy leaves pass through."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    if isinstance(params, np.ndarray):
        return params
    return _numpy(params)


def flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict/list -> ``{"dotted.path": array}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: np.asarray(tree)}
    out: dict[str, np.ndarray] = {}
    for key, value in items:
        out.update(flatten(value, f"{prefix}.{key}" if prefix else str(key)))
    return out


def unflatten(flat: dict[str, np.ndarray]) -> Any:
    """Inverse of :func:`flatten`: all-digit path parts become list
    indices (``blocks.0`` -> ``blocks[0]``)."""
    root: dict = {}
    for path, value in flat.items():
        node = root
        *parents, leaf = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def save_npz(path: str, tree: Any) -> None:
    """Write a params tree (numpy or torch leaves) as a flat ``.npz``."""
    np.savez(path, **flatten(params_to_numpy(tree)))


def load_npz(path: str, *, device: torch.device | str = "cpu") -> Any:
    """Read a ``.npz`` written by :func:`save_npz` (from either package's
    params) into port parameters on ``device``."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return params_from_jax(unflatten(flat), device=device)


# ---------------------------------------------------------------------------
# optimizer state and whole training states
# ---------------------------------------------------------------------------

def _fields(state: Any) -> dict:
    """The fields of an optax / port NamedTuple state, or of a dict."""
    if hasattr(state, "_asdict"):
        return dict(state._asdict())
    return dict(state)


def _opt_state_from_fields(fields: dict, device) -> tuple:
    if "sum_of_squares" in fields:
        first = ScaleByRssState(
            params_from_jax(fields["sum_of_squares"], device=device))
    elif "mu" in fields:
        first = ScaleByAdamState(
            count=params_from_jax(fields["count"], device=device),
            mu=params_from_jax(fields["mu"], device=device),
            nu=params_from_jax(fields["nu"], device=device))
    elif not fields:
        first = EmptyState()
    else:
        raise ValueError(f"unrecognised optimizer state fields "
                         f"{sorted(fields)}")
    return (first, EmptyState())


def opt_state_from_jax(opt_state: Any, *,
                       device: torch.device | str = "cpu") -> tuple:
    """optax ``(ScaleByRssState | ScaleByAdamState | EmptyState,
    EmptyState)`` with numpy leaves -> the port's state on ``device``."""
    return _opt_state_from_fields(_fields(opt_state[0]), device)


def opt_state_to_numpy(opt_state: tuple) -> tuple:
    """The port's optimizer state -> the same NamedTuples, numpy leaves."""
    first = opt_state[0]
    return (type(first)(**{k: params_to_numpy(v)
                           for k, v in _fields(first).items()}),
            EmptyState())


def train_state_from_jax(ts: Any, *, device: torch.device | str = "cpu",
                         seed: int = 0):
    """A JAX ``TrainState`` with numpy leaves (``jax.tree.map(np.asarray,
    ts)``) -> the port's ``TrainState`` on ``device``, with a fresh
    generator seeded from ``seed``."""
    from sharetrade_tpu_torch.agents.base import TrainState
    from sharetrade_tpu_torch.env.trading import EnvState

    def tensor(x):
        return _tensor(x, device)

    env = ts.env_state
    return TrainState(
        params=params_from_jax(ts.params, device=device),
        opt_state=opt_state_from_jax(ts.opt_state, device=device),
        carry={k: tensor(v) for k, v in ts.carry.items()},
        env_state=EnvState(*(tensor(getattr(env, f)) for f in _ENV_FIELDS)),
        rng=torch.Generator(device=device).manual_seed(seed),
        env_steps=tensor(ts.env_steps), updates=tensor(ts.updates))


def train_state_to_numpy(ts: Any) -> dict:
    """The port's ``TrainState`` -> ``{"params", "opt_state", "carry",
    "env_state", "env_steps", "updates"}`` with numpy leaves (the env
    state as a dict of its four fields)."""
    return {
        "params": params_to_numpy(ts.params),
        "opt_state": opt_state_to_numpy(ts.opt_state),
        "carry": params_to_numpy(ts.carry),
        "env_state": {f: params_to_numpy(getattr(ts.env_state, f))
                      for f in _ENV_FIELDS},
        "env_steps": params_to_numpy(ts.env_steps),
        "updates": params_to_numpy(ts.updates),
    }


def save_train_state_npz(path: str, ts: Any) -> None:
    """Write a training state (the port's, or a JAX one with numpy leaves)
    as a flat ``.npz``: ``params.*``, ``opt_state.*`` (the first optax
    element's fields), ``carry.*``, ``env_state.*``, ``env_steps``,
    ``updates``. A bfloat16 carry leaf is stored as float32 (exactly: npz
    has no bfloat16); the precision policy's ``cast_carry`` restores it."""
    env = ts.env_state

    def carry_leaf(x):
        x = params_to_numpy(x)
        return x.astype(np.float32) if x.dtype.name == "bfloat16" else x

    tree = {
        "params": params_to_numpy(ts.params),
        "opt_state": {k: params_to_numpy(v)
                      for k, v in _fields(ts.opt_state[0]).items()},
        "carry": {k: carry_leaf(v) for k, v in ts.carry.items()},
        "env_state": {f: params_to_numpy(getattr(env, f))
                      for f in _ENV_FIELDS},
        "env_steps": params_to_numpy(ts.env_steps),
        "updates": params_to_numpy(ts.updates),
    }
    np.savez(path, **flatten(tree))


def load_train_state_npz(path: str, *, device: torch.device | str = "cpu",
                         seed: int = 0):
    """Read :func:`save_train_state_npz`'s file into a port
    ``TrainState``; returns None when the file holds a bare params tree
    (:func:`save_npz`) instead."""
    from sharetrade_tpu_torch.agents.base import TrainState
    from sharetrade_tpu_torch.env.trading import EnvState

    with np.load(path) as data:
        tree = unflatten({k: data[k] for k in data.files})
    if "env_steps" not in tree:
        return None

    def tensor(x):
        return _tensor(x, device)

    return TrainState(
        params=params_from_jax(tree["params"], device=device),
        opt_state=_opt_state_from_fields(tree.get("opt_state", {}), device),
        carry={k: tensor(v) for k, v in tree["carry"].items()},
        env_state=EnvState(*(tensor(tree["env_state"][f])
                             for f in _ENV_FIELDS)),
        rng=torch.Generator(device=device).manual_seed(seed),
        env_steps=tensor(tree["env_steps"]), updates=tensor(tree["updates"]))
