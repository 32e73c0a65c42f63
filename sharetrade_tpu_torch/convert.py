"""Carry weights between the JAX package and the port.

A JAX params pytree, with its leaves turned into numpy arrays (for example
``jax.tree.map(np.asarray, params)``), is a nested ``dict``/``list`` of
arrays. The port's parameters are the same tree with ``torch.Tensor`` leaves:

    embed/port/policy/value   {"w": (in, out), "b": (out,)}
    final_ln                  {"scale": (d,), "bias": (d,)}
    blocks[i]                 {"ln1", "qkv", "proj", "ln2", "mlp_in",
                               "mlp_out"} with the same leaves, or "moe":
                              {"gate": (d, E), "w_in": (E, d, 4d),
                               "w_out": (E, 4d, d)} in place of the MLP
    pos, asset                (window+1, d), (A, d) (the window transformer)
    LSTM                      input/gates/policy/value dense layers
    TCN                       embed/port/policy/value, blocks[i].conv
                              {"w": (K, C_in, C_out), "b"} and .mix

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
(``t, budget, shares, share_value``; the portfolio env's shares and
share values with a trailing asset axis); the model carry (a dict, the
LSTM's ``(h, c)`` tuple, or a stateless model's empty tuple, which becomes
``{}``); ``env_steps`` and ``updates``; and DQN's
extras (target params, replay buffer, PER sum-tree levels and max
priority; ``agents/dqn.py``). Every leaf keeps its dtype and bytes, so the round trip is
bitwise. The JAX random key has no torch counterpart: the port's state gets
a fresh generator. :func:`save_train_state_npz` writes such a state as one
``.npz`` (``cli train --params`` boots from it).

On disk (:func:`encode_train_state`, shared with the checkpoint manager) a
bfloat16 leaf is stored as its ``uint16`` bits with its dtype recorded
beside the arrays, so the round trip is bitwise at half the bytes of a
float32 upcast, and a port state's generator is stored as its
``get_state()`` bytes (``rng``, ``uint8``), so a resumed run draws the same
permutations and noise as the run it continues. Every file is read with
``allow_pickle=False``.
"""

from __future__ import annotations

import json
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
    (bfloat16 arrays — ml_dtypes' — travel as their uint16 bits); a tensor
    is moved as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
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


def flatten(tree: Any, prefix: str = "", leaf=np.asarray) -> dict[str, Any]:
    """Nested dict/list -> ``{"dotted.path": leaf(x)}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: leaf(tree)}
    out: dict[str, Any] = {}
    for key, value in items:
        out.update(flatten(value, f"{prefix}.{key}" if prefix else str(key),
                           leaf))
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
    with np.load(path, allow_pickle=False) as data:
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
        carry=_carry(ts.carry, tensor),
        env_state=EnvState(*(tensor(getattr(env, f)) for f in _ENV_FIELDS)),
        rng=torch.Generator(device=device).manual_seed(seed),
        env_steps=tensor(ts.env_steps), updates=tensor(ts.updates),
        extras=extras_from_jax(getattr(ts, "extras", None), device=device))


def _carry(carry: Any, leaf) -> Any:
    """A model carry with ``leaf`` applied to its leaves: a dict stays a
    dict, the LSTM's ``(h, c)`` (a tuple, or the list an unflattened file
    gives) a tuple, a stateless model's empty carry (JAX ``()``) ``{}``."""
    if isinstance(carry, dict):
        return {k: leaf(v) for k, v in carry.items()}
    if isinstance(carry, (list, tuple)) and carry:
        return tuple(leaf(v) for v in carry)
    return {}


def extras_from_jax(extras: Any, *, device: torch.device | str = "cpu"):
    """A JAX DQN extras (``DQNExtras`` or ``DQNExtrasPER``: target params,
    the replay buffer and, under PER, the sum-tree and max priority) with
    numpy leaves -> the port's ``DQNExtras`` on ``device``; None stays
    None."""
    if extras is None:
        return None
    from sharetrade_tpu_torch.agents.dqn import PerState, ReplayBuffer, DQNExtras
    from sharetrade_tpu_torch.ops.sum_tree import SumTree

    def tensor(x):
        return _tensor(x, device)

    replay = extras.replay
    per = getattr(extras, "per", None)
    return DQNExtras(
        target_params=params_from_jax(extras.target_params, device=device),
        replay=ReplayBuffer(**{f: tensor(getattr(replay, f)) for f in (
            "obs", "action", "reward", "next_obs", "pos", "size")}),
        per=None if per is None else PerState(
            tree=SumTree(levels=[tensor(x) for x in per.tree.levels]),
            max_priority=tensor(per.max_priority)))


def train_state_to_numpy(ts: Any) -> dict:
    """The port's ``TrainState`` -> ``{"params", "opt_state", "carry",
    "env_state", "env_steps", "updates"}`` with numpy leaves (the env
    state as a dict of its four fields), and ``"extras"`` (DQN's, as the
    nested dict of ``agents.dqn.extras_tree``) when the state has them."""
    out = {
        "params": params_to_numpy(ts.params),
        "opt_state": opt_state_to_numpy(ts.opt_state),
        "carry": params_to_numpy(ts.carry),
        "env_state": {f: params_to_numpy(getattr(ts.env_state, f))
                      for f in _ENV_FIELDS},
        "env_steps": params_to_numpy(ts.env_steps),
        "updates": params_to_numpy(ts.updates),
    }
    if getattr(ts, "extras", None) is not None:
        out["extras"] = params_to_numpy(_extras_tree(ts.extras))
    return out


def _extras_tree(extras: Any) -> dict:
    """A port ``DQNExtras`` as its nested dict; a JAX one (numpy leaves)
    the same way."""
    from sharetrade_tpu_torch.agents.dqn import DQNExtras, extras_tree
    if not isinstance(extras, DQNExtras):
        extras = extras_from_jax(extras)
    return extras_tree(extras)


#: The ``.npz`` entry that records which leaves are stored as bf16 bits.
_DTYPES_KEY = "__dtypes__"


def _encode(x) -> tuple[np.ndarray, str | None]:
    """A leaf (tensor or numpy) as host bytes numpy can store, and the dtype
    to record when they are not the leaf's own (bfloat16 as uint16 bits).
    A CPU tensor's array shares its memory."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return x.numpy(), None
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, None


def decode_leaf(a: np.ndarray, dtype: str | None) -> torch.Tensor:
    """Inverse of :func:`_encode`, as a CPU tensor."""
    a = a if a.flags.writeable else a.copy()
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if dtype is not None:
        raise ValueError(f"unknown stored dtype {dtype!r}")
    return torch.from_numpy(a)


def train_state_leaves(ts: Any) -> dict[str, Any]:
    """A training state (the port's, or a JAX one with numpy leaves) as
    ``{"dotted.path": leaf}``, leaves as they are: ``params.*``,
    ``opt_state.*`` (the first optax element's fields), ``carry.*``,
    ``env_state.*``, ``env_steps``, ``updates``, DQN's ``extras.*``
    (``extras.target_params.*``, ``extras.replay.*``, ``extras.per.*``)
    and, for a port state, ``rng`` (the generator's ``get_state()``, a CPU
    ``uint8`` tensor)."""
    env = ts.env_state
    tree = {
        "params": ts.params,
        "opt_state": _fields(ts.opt_state[0]),
        "carry": _carry(ts.carry, lambda x: x),
        "env_state": {f: getattr(env, f) for f in _ENV_FIELDS},
        "env_steps": ts.env_steps,
        "updates": ts.updates,
    }
    if getattr(ts, "extras", None) is not None:
        tree["extras"] = _extras_tree(ts.extras)
    flat = flatten(tree, leaf=lambda x: x)
    if isinstance(ts.rng, torch.Generator):
        flat["rng"] = ts.rng.get_state()
    return flat


def encode_train_state(leaves: dict[str, Any]
                       ) -> tuple[dict[str, np.ndarray], dict[str, str]]:
    """:func:`train_state_leaves`' output as host arrays, and the dtypes
    of the leaves stored as other bits (``{"carry.k": "bfloat16"}``)."""
    arrays, dtypes = {}, {}
    for name, leaf in leaves.items():
        arrays[name], dtype = _encode(leaf)
        if dtype is not None:
            dtypes[name] = dtype
    return arrays, dtypes


def _generator(device, state: np.ndarray | None, seed: int):
    """A generator on ``device`` with the stored state, or seeded from
    ``seed`` when none was stored. A state of another device's generator
    raises ``RuntimeError``."""
    generator = torch.Generator(device=device)
    if state is None:
        return generator.manual_seed(seed)
    generator.set_state(torch.from_numpy(np.array(state, np.uint8)))
    return generator


def decode_train_state(arrays: dict[str, np.ndarray], dtypes: dict[str, str],
                       *, device: torch.device | str = "cpu", seed: int = 0):
    """Inverse of :func:`encode_train_state`: a port ``TrainState`` on
    ``device``, its generator seeded from ``seed`` when none was stored."""
    from sharetrade_tpu_torch.agents.base import TrainState
    from sharetrade_tpu_torch.env.trading import EnvState

    from sharetrade_tpu_torch.agents.dqn import extras_from_tree

    tensors = {k: decode_leaf(a, dtypes.get(k)).to(device)
               for k, a in arrays.items() if k != "rng"}
    tree = unflatten(tensors)
    return TrainState(
        params=tree["params"],
        opt_state=_opt_state_from_fields(tree.get("opt_state", {}), device),
        carry=_carry(tree.get("carry", {}), lambda x: x),
        env_state=EnvState(*(tree["env_state"][f] for f in _ENV_FIELDS)),
        rng=_generator(device, arrays.get("rng"), seed),
        env_steps=tree["env_steps"], updates=tree["updates"],
        extras=extras_from_tree(tree["extras"]) if "extras" in tree
        else None)


def save_train_state_npz(path: str, ts: Any) -> None:
    """Write a training state (the port's, or a JAX one with numpy leaves)
    as a flat ``.npz`` (:func:`train_state_leaves`' names), bf16 leaves as
    their bits with the dtypes in the ``__dtypes__`` entry (JSON bytes)."""
    arrays, dtypes = encode_train_state(train_state_leaves(ts))
    arrays[_DTYPES_KEY] = np.frombuffer(json.dumps(dtypes).encode(),
                                        np.uint8)
    np.savez(path, **arrays)


def load_train_state_npz(path: str, *, device: torch.device | str = "cpu",
                         seed: int = 0):
    """Read :func:`save_train_state_npz`'s file into a port
    ``TrainState``; returns None when the file holds a bare params tree
    (:func:`save_npz`) instead. A file with no generator state (a JAX
    state's) gives a generator seeded from ``seed``; one saved from another
    device's generator raises ``RuntimeError``. Files written before bf16
    bits were kept hold a float32 carry, which the precision policy's
    ``cast_carry`` brings back."""
    with np.load(path, allow_pickle=False) as data:
        arrays = {k: data[k] for k in data.files}
    if "env_steps" not in arrays:
        return None
    dtypes = json.loads(arrays.pop(_DTYPES_KEY).tobytes().decode()
                        if _DTYPES_KEY in arrays else "{}")
    return decode_train_state(arrays, dtypes, device=device, seed=seed)
