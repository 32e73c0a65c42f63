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
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def params_from_jax(tree: Any, *, device: torch.device | str = "cpu") -> Any:
    """JAX params pytree (numpy leaves) -> port parameters on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device=device) for v in tree]
    return torch.tensor(np.asarray(tree), device=device)


def params_to_numpy(params: Any) -> Any:
    """Port parameters -> the same tree with numpy leaves (on the host);
    numpy leaves pass through."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    if isinstance(params, np.ndarray):
        return params
    return params.detach().cpu().numpy()


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
