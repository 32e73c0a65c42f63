"""Fused optimizer update: grad upcast + moment update + param update (+
optional bf16 recast) in ONE pass over every parameter leaf.

Counterpart of the JAX package's ``ops/fused_update.py``. The op order is
optax's (``scale_by_rss`` / ``scale_by_adam`` / ``sgd``, then
``scale_by_learning_rate`` and ``apply_updates``), so in float32 the plain
version computes what the optax pair computes; bf16 gradients are upcast
before any arithmetic, and masters and moments stay float32.

- :func:`fused_update` is the kernel wrapper over flat lists of leaves. On
  CUDA tensors it launches the hand-written kernel ``csrc/fused_update.cu``
  ONCE for all leaves (up to 64 per launch; built at first use) or raises;
  on CPU tensors it runs the plain per-leaf math. No fallback between them.
- :func:`fused_apply` is the tree-level entry the learners call, with the
  optax-shaped state (``ScaleByRssState`` / ``ScaleByAdamState`` /
  ``EmptyState`` tuples, the same field names).

Unlike the JAX package, which returns new arrays, the port updates the
master parameters and the optimizer moments IN PLACE (and returns the same
objects): the update is a pure stream, and writing it back where it was read
halves its memory. Where the JAX learners keep the old state with
``where(flag, new, old)`` (Q-learning and DQN steps with no active agent or
an unready replay), the port passes ``gate=flag``: a device tensor that the
kernel and the plain version both read, so the update leaves everything,
adam's count included, as it was when the flag is false, and the host never
waits for the flag's value.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import torch

from sharetrade_tpu_torch.models.core import tree_leaves, tree_map, unflatten_like
from sharetrade_tpu_torch.ops import cuda_build

#: optax defaults, as the JAX package replicates them.
ADAGRAD_INIT = 0.1
ADAGRAD_EPS = 1e-7
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8

OPTIMIZERS = ("adagrad", "adam", "sgd")
_OPT_CODES = {"adagrad": 0, "adam": 1, "sgd": 2}
_GRAD_CODES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches, counted where the kernel is launched and nowhere else.
launch_counts: dict[str, int] = {"fused_update": 0}


def reset_launch_counts() -> None:
    launch_counts["fused_update"] = 0


class ScaleByRssState(NamedTuple):
    sum_of_squares: Any


class ScaleByAdamState(NamedTuple):
    count: Any
    mu: Any
    nu: Any


class EmptyState(NamedTuple):
    pass


def init_state(optimizer: str, params: Any) -> tuple:
    """optax's initial state for ``optimizer`` over ``params``: adagrad's
    ``sum_of_squares`` starts at 0.1, adam's count at 0 and moments at 0."""
    if optimizer == "adagrad":
        return (ScaleByRssState(tree_map(lambda p: torch.full_like(
            p, ADAGRAD_INIT, dtype=torch.float32), params)), EmptyState())
    if optimizer == "adam":
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        device = tree_leaves(params)[0].device
        return (ScaleByAdamState(
            count=torch.zeros((), dtype=torch.int32, device=device),
            mu=tree_map(zeros, params), nu=tree_map(zeros, params)), EmptyState())
    if optimizer == "sgd":
        return (EmptyState(), EmptyState())
    raise ValueError(f"unknown optimizer {optimizer!r}")


# ---------------------------------------------------------------------------
# plain per-leaf math (optax op order)
# ---------------------------------------------------------------------------

def _plain_leaf(optimizer: str, lr: float, p, g, state: list, bias,
                gate=None):
    """One leaf's new (p, state) in float32; with ``gate`` false the old
    ones."""
    if gate is not None:
        p_new, s_new = _plain_leaf(optimizer, lr, p, g, state, bias)
        return (torch.where(gate, p_new, p),
                [torch.where(gate, new, old) for new, old in zip(s_new, state)])
    g = g.float()
    if optimizer == "adagrad":
        (s,) = state
        s_new = g * g + s
        inv = torch.where(s_new > 0, torch.rsqrt(s_new + ADAGRAD_EPS),
                          torch.zeros_like(s_new))
        return p + (inv * g) * (-lr), [s_new]
    if optimizer == "adam":
        mu, nu = state
        mu_new = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
        nu_new = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu
        mu_hat = mu_new / bias[0]
        nu_hat = nu_new / bias[1]
        u = mu_hat / (torch.sqrt(nu_hat + 0.0) + ADAM_EPS)
        return p + u * (-lr), [mu_new, nu_new]
    return p + g * (-lr), []


def adam_bias(count: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(incremented count, [1 - b1^count, 1 - b2^count]) on count's device,
    the increment saturating at int32 max as optax's does."""
    count_inc = torch.where(count < torch.iinfo(torch.int32).max, count + 1,
                            count)
    c = count_inc.float()
    return count_inc, torch.stack([1.0 - torch.pow(ADAM_B1, c),
                                   1.0 - torch.pow(ADAM_B2, c)])


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_update")
    fn = lib.fused_update
    if fn.argtypes is None:
        ptrs = ctypes.POINTER(ctypes.c_longlong)
        fn.argtypes = ([ctypes.c_int] * 4 + [ptrs] * 6
                       + [ctypes.c_float] + [ctypes.c_void_p] * 3
                       + [ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
    return lib


def _check(optimizer, params, grads, state, compute) -> None:
    n_state = {"adagrad": 1, "adam": 2, "sgd": 0}[optimizer]
    if len(state) != n_state:
        raise ValueError(f"fused_update: {optimizer} takes {n_state} state "
                         f"lists, got {len(state)}")
    lists = [("grads", grads)] + [(f"state[{j}]", s)
                                  for j, s in enumerate(state)]
    if compute is not None:
        lists.append(("compute", compute))
    for label, leaves in lists:
        if len(leaves) != len(params):
            raise ValueError(f"fused_update: {len(leaves)} {label} leaves "
                             f"for {len(params)} params")
    device = params[0].device
    grad_dtype = grads[0].dtype
    if grad_dtype not in _GRAD_CODES:
        raise ValueError(f"fused_update: grads are {grad_dtype}; the kernel "
                         f"takes {sorted(map(str, _GRAD_CODES))}")
    for i, p in enumerate(params):
        tensors = [("param", p, torch.float32), ("grad", grads[i], grad_dtype)]
        tensors += [(f"state[{j}]", s[i], torch.float32)
                    for j, s in enumerate(state)]
        if compute is not None:
            tensors.append(("compute", compute[i], torch.bfloat16))
        for label, t, dtype in tensors:
            if t.device != device or t.device.type != "cuda":
                raise ValueError(f"fused_update: {label} leaf {i} is on "
                                 f"{t.device}, expected {device} (CUDA)")
            if t.dtype != dtype:
                raise ValueError(f"fused_update: {label} leaf {i} is "
                                 f"{t.dtype}, expected {dtype}")
            if t.shape != p.shape:
                raise ValueError(f"fused_update: {label} leaf {i} has shape "
                                 f"{tuple(t.shape)}, param {tuple(p.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"fused_update: {label} leaf {i} must be "
                                 "contiguous")


def fused_update(optimizer: str, lr: float, params: list, grads: list,
                 state: list[list], *, bias: torch.Tensor | None = None,
                 compute: list | None = None,
                 gate: torch.Tensor | None = None) -> None:
    """Update ``params`` and the ``state`` moment lists IN PLACE from
    ``grads`` (one list entry per leaf; ``state`` holds one list for
    adagrad's sum of squares, two for adam's mu and nu, none for sgd).
    ``bias`` is adam's 2-element ``[1 - b1^count, 1 - b2^count]`` tensor
    (:func:`adam_bias`); ``compute``, when given, receives the bfloat16
    recast of each new master; ``gate``, a one-element bool or integer
    tensor on the params' device, updates nothing where it is false (the
    compute copy is then the recast of the unchanged masters). CUDA tensors
    launch the kernel (one launch for up to 64 leaves); CPU tensors take the
    plain version."""
    if optimizer not in _OPT_CODES:
        raise ValueError(f"fused update does not support optimizer "
                         f"{optimizer!r}; choose from {OPTIMIZERS}")
    if optimizer == "adam" and bias is None:
        raise ValueError("fused_update: adam needs its bias corrections")
    if not params:
        return
    if gate is not None:
        if gate.numel() != 1 or gate.device != params[0].device:
            raise ValueError("fused_update: gate must be a one-element "
                             f"tensor on {params[0].device}")
        gate = gate.reshape(())
    if params[0].device.type == "cpu":
        flag = None if gate is None else gate.bool()
        for i, p in enumerate(params):
            p_new, s_new = _plain_leaf(optimizer, lr, p, grads[i],
                                       [s[i] for s in state], bias, flag)
            p.copy_(p_new)
            for s, new in zip(state, s_new):
                s[i].copy_(new)
            if compute is not None:
                compute[i].copy_(p_new)
        return
    _check(optimizer, params, grads, state, compute)
    if bias is not None and (bias.device != params[0].device
                             or bias.dtype != torch.float32
                             or bias.shape != (2,)):
        raise ValueError("fused_update: bias must be a float32 (2,) tensor "
                         f"on {params[0].device}")
    n = len(params)
    flag = None if gate is None else gate.to(torch.int32).reshape(1)

    def table(leaves):
        return (ctypes.c_longlong * n)(*[
            0 if leaves is None else leaves[i].data_ptr() for i in range(n)])

    launches = ctypes.c_int(0)
    with torch.cuda.device(params[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().fused_update(
            _OPT_CODES[optimizer], _GRAD_CODES[grads[0].dtype],
            0 if compute is None else 1, n,
            table(params), table(grads),
            table(state[0] if state else None),
            table(state[1] if len(state) > 1 else None),
            table(compute),
            (ctypes.c_longlong * n)(*[p.numel() for p in params]),
            float(lr), None if bias is None else bias.data_ptr(),
            None if gate is None else flag.data_ptr(), stream,
            ctypes.byref(launches))
    if err != 0:
        raise RuntimeError(f"fused_update kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["fused_update"] += launches.value


# ---------------------------------------------------------------------------
# tree-level entry
# ---------------------------------------------------------------------------

def fused_apply(optimizer_name: str, lr: float, grads: Any, opt_state: tuple,
                params: Any, *, emit_compute: bool = False,
                gate: torch.Tensor | None = None):
    """One fused pass over the parameter tree, IN PLACE; with ``gate``
    (a one-element device tensor) false it changes nothing, adam's count
    included.

    Returns ``(params, opt_state[, compute_params])`` — the same objects
    that came in, updated, plus (``emit_compute``) a fresh tree of the new
    masters cast to bfloat16 (the compute dtype of ``bf16_mixed``, the only
    mixed mode), written by the same pass. ``grads``
    has the tree structure of ``params`` (or is its list of leaves) in any
    float dtype; the upcast happens inside the pass. ``opt_state`` is
    :func:`init_state`'s tuple."""
    if optimizer_name not in _OPT_CODES:
        raise ValueError(f"fused update does not support optimizer "
                         f"{optimizer_name!r}; choose from {OPTIMIZERS}")
    flat_p = tree_leaves(params)
    flat_g = [g.contiguous() for g in tree_leaves(grads)]
    bias = None
    first = opt_state[0]
    if optimizer_name == "adagrad":
        state = [tree_leaves(first.sum_of_squares)]
    elif optimizer_name == "adam":
        count_inc, bias = adam_bias(first.count)
        state = [tree_leaves(first.mu), tree_leaves(first.nu)]
    else:
        state = []
    compute = ([torch.empty_like(p, dtype=torch.bfloat16) for p in flat_p]
               if emit_compute else None)
    fused_update(optimizer_name, lr, flat_p, flat_g, state, bias=bias,
                 compute=compute, gate=gate)
    if optimizer_name == "adam":
        if gate is not None:
            count_inc = torch.where(gate.reshape(()).bool(), count_inc,
                                    first.count)
        first.count.copy_(count_inc)
    if emit_compute:
        return params, opt_state, unflatten_like(params, compute)
    return params, opt_state
