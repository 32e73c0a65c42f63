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
  Its launch plan (:func:`plan_update`: tiles, the leaves' prefix table,
  the split into launches) is pure arithmetic of the leaf sizes, built once
  per leaf shapes and kept with a reusable ctypes table; a call checks each
  list of leaves in one pass and writes their current addresses into it.
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
import functools
import operator
import threading
from collections import OrderedDict
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
# the launch plan (pure arithmetic of the leaf sizes; the CPU tests walk it)
# ---------------------------------------------------------------------------

#: Elements a vector: a float4 of each f32 operand, 8 bytes of each bf16
#: one (``csrc/fused_update.cu`` kVec).
VEC = 4
#: Elements a thread updates in a tile, by optimizer: two vectors,
#: ``VEC * tile_units`` apart so a warp's accesses are contiguous; one for
#: adam, whose four f32 streams would hold twice the registers
#: (``kVecsOf`` in the kernel).
UNITS = {"adagrad": 2 * VEC, "adam": VEC, "sgd": 2 * VEC}
#: Leaves a launch takes (the kernel's by-value table, kMaxLeaves).
MAX_LEAVES = 64
#: Block sizes, largest first; a tile is one unit per thread of a block.
TILE_UNITS = (128, 64, 32)


class UpdatePlan(NamedTuple):
    """How one launch set covers a list of leaves.

    ``tile_units`` threads per block, each updating ``unit`` elements
    (:data:`UNITS`), so a tile is ``tile_units * unit`` contiguous elements
    of one leaf; ``tile_start[j]`` is the number of tiles of leaves ``0..j-1`` (the
    prefix table the kernel searches; ``len(sizes) + 1`` entries);
    ``launches`` the ``(first, end)`` leaf ranges launched, at most
    ``MAX_LEAVES`` leaves each, in order, those without a tile left out."""
    unit: int
    tile_units: int
    tile_start: tuple
    launches: tuple


def plan_update(sizes: list[int], sms: int, unit: int) -> UpdatePlan:
    """The plan for leaves of ``sizes`` elements on a card with ``sms``
    SMs, ``unit`` elements a thread: the largest block whose tiles number
    at least ``sms`` (so a small set still spreads over the SMs; 32 threads
    when none does), each leaf cut into whole tiles starting at its
    element 0."""
    units = [-(-n // unit) for n in sizes]
    tile_units = next((t for t in TILE_UNITS
                       if sum(-(-u // t) for u in units) >= sms),
                      TILE_UNITS[-1])
    tile_start = [0]
    for u in units:
        tile_start.append(tile_start[-1] + -(-u // tile_units))
    launches = tuple(
        (first, min(first + MAX_LEAVES, len(sizes)))
        for first in range(0, len(sizes), MAX_LEAVES)
        if tile_start[min(first + MAX_LEAVES, len(sizes))] > tile_start[first])
    return UpdatePlan(unit, tile_units, tuple(tile_start), launches)


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

class _Call(ctypes.Structure):
    """``FusedUpdateCall`` of ``csrc/fused_update.cu``, field for field."""
    _fields_ = [("optimizer", ctypes.c_int), ("grad_dtype", ctypes.c_int),
                ("emit", ctypes.c_int), ("n_leaves", ctypes.c_int),
                ("tile_units", ctypes.c_int), ("unit", ctypes.c_int),
                ("n_launches", ctypes.c_int),
                ("launch_leaves", ctypes.c_void_p),
                ("tile_start", ctypes.c_void_p), ("sizes", ctypes.c_void_p),
                ("p", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("s1", ctypes.c_void_p), ("s2", ctypes.c_void_p),
                ("pc", ctypes.c_void_p), ("lr", ctypes.c_float),
                ("bias", ctypes.c_void_p), ("gate", ctypes.c_void_p),
                ("gate_bytes", ctypes.c_int), ("stream", ctypes.c_void_p),
                ("launched", ctypes.c_int)]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_update")
    fn = lib.fused_update
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check_leaves(label: str, leaves: list, dtype, shapes: list,
                  device: torch.device) -> None:
    """Raise on the first leaf of ``leaves`` that is not a contiguous
    ``dtype`` tensor of its param's shape on ``device``."""
    if len(leaves) != len(shapes):
        raise ValueError(f"fused_update: {len(leaves)} {label} leaves for "
                         f"{len(shapes)} params")
    for i, t in enumerate(leaves):
        if t.device != device:
            raise ValueError(f"fused_update: {label} leaf {i} is on "
                             f"{t.device}, expected {device}")
        if t.dtype != dtype:
            raise ValueError(f"fused_update: {label} leaf {i} is "
                             f"{t.dtype}, expected {dtype}")
        if t.shape != shapes[i]:
            raise ValueError(f"fused_update: {label} leaf {i} has shape "
                             f"{tuple(t.shape)}, param {tuple(shapes[i])}")
        if not t.is_contiguous():
            raise ValueError(f"fused_update: {label} leaf {i} must be "
                             "contiguous")


_dtype_of = operator.attrgetter("dtype")
_shape_of = operator.attrgetter("shape")


class _Plan:
    """The launch plan of leaves of ``shapes`` on device ``index`` and the
    ctypes call that carries it. It holds no tensor: every call checks each
    list it is given in one pass (dtype, shape, device, contiguity) and
    writes the leaves' current addresses into the call's arrays in place, so
    a tensor whose storage was swapped (``set_``, ``.data =``) is launched
    at its new address, and one whose shape, dtype or strides changed
    raises. ``lock`` makes a call's binding and launch one step, so two
    threads updating leaf sets of the same shapes do not mix addresses."""

    def __init__(self, optimizer: str, grad_dtype, emit: bool, shapes,
                 index: int, sms: int):
        self.index = index
        self.device = (torch.device("cuda", index) if index >= 0
                       else torch.device("cpu"))
        self.shapes = list(shapes)
        self.n = n = len(shapes)
        self.indices = [index] * n
        self.dtypes = {dtype: [dtype] * n
                       for dtype in (torch.float32, *_GRAD_CODES)}
        sizes = [s.numel() for s in shapes]
        plan = plan_update(sizes, sms, UNITS[optimizer])
        arrays = {name: (ctypes.c_longlong * n)()
                  for name in ("p", "g", "s1", "s2", "pc", "sizes")}
        arrays["sizes"][:] = sizes
        arrays["launch_leaves"] = (ctypes.c_int * (2 * len(plan.launches)))(
            *[j for launch in plan.launches for j in launch])
        arrays["tile_start"] = (ctypes.c_int * (n + 1))(*plan.tile_start)
        self.arrays = arrays
        self.call = _Call(
            optimizer=_OPT_CODES[optimizer], grad_dtype=_GRAD_CODES[grad_dtype],
            emit=int(emit), n_leaves=n, tile_units=plan.tile_units,
            unit=plan.unit, n_launches=len(plan.launches),
            **{name: ctypes.addressof(arr) for name, arr in arrays.items()})
        self.address = ctypes.addressof(self.call)
        self.launch = None    # the C entry point, loaded at the first launch
        self.lock = threading.Lock()

    def bind(self, slot: str, label: str, leaves: list, dtype,
             shapes: tuple | None = None) -> None:
        """Point the call's ``slot`` array at ``leaves`` after one pass of
        checks: each a contiguous ``dtype`` tensor of its param's shape on
        the plan's device (``shapes``: the leaves' shapes, where the caller
        has them)."""
        if shapes is None:
            shapes = list(map(_shape_of, leaves))
        if not (len(leaves) == self.n
                and list(map(_dtype_of, leaves)) == self.dtypes[dtype]
                and list(shapes) == self.shapes
                and list(map(torch.Tensor.get_device, leaves)) == self.indices
                and all(map(torch.Tensor.is_contiguous, leaves))):
            _check_leaves(label, leaves, dtype, self.shapes, self.device)
        self.arrays[slot][:] = list(map(torch.Tensor.data_ptr, leaves))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


#: Plans by (optimizer, grad dtype, emit, device, the leaves' shapes), the
#: most recently used last. A plan holds no tensor, only its ctypes tables.
_PLANS: OrderedDict[tuple, _Plan] = OrderedDict()
_MAX_PLANS = 8


def _plan_for(optimizer: str, grad_dtype, emit: bool, shapes: tuple,
              index: int) -> _Plan:
    key = (optimizer, grad_dtype, emit, index, shapes)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _Plan(optimizer, grad_dtype, emit, shapes, index, _sms(index))
        _PLANS[key] = plan
        while len(_PLANS) > _MAX_PLANS:
            _PLANS.popitem(last=False)
    else:
        _PLANS.move_to_end(key)
    return plan


_N_STATE = {"adagrad": 1, "adam": 2, "sgd": 0}


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
    launch the kernel (one launch for up to 64 leaves; nothing synchronises
    and nothing is copied from the host, so the call can be captured in a
    CUDA graph); CPU tensors take the plain version."""
    if optimizer not in _OPT_CODES:
        raise ValueError(f"fused update does not support optimizer "
                         f"{optimizer!r}; choose from {OPTIMIZERS}")
    if optimizer == "adam" and bias is None:
        raise ValueError("fused_update: adam needs its bias corrections")
    if not params:
        return
    if gate is not None and (gate.numel() != 1
                             or gate.get_device() != params[0].get_device()
                             or gate.dtype.is_floating_point
                             or gate.dtype.is_complex):
        raise ValueError("fused_update: gate must be a one-element bool or "
                         f"integer tensor on {params[0].device}")
    if params[0].is_cpu:
        flag = None if gate is None else gate.reshape(()).bool()
        for i, p in enumerate(params):
            p_new, s_new = _plain_leaf(optimizer, lr, p, grads[i],
                                       [s[i] for s in state], bias, flag)
            p.copy_(p_new)
            for s, new in zip(state, s_new):
                s[i].copy_(new)
            if compute is not None:
                compute[i].copy_(p_new)
        return
    n_state = _N_STATE[optimizer]
    if len(state) != n_state:
        raise ValueError(f"fused_update: {optimizer} takes {n_state} state "
                         f"lists, got {len(state)}")
    grad_dtype = grads[0].dtype if grads else None
    if grad_dtype not in _GRAD_CODES:
        raise ValueError(f"fused_update: grads are {grad_dtype}; the kernel "
                         f"takes {sorted(map(str, _GRAD_CODES))}")
    if bias is not None and (bias.get_device() != params[0].get_device()
                             or bias.dtype != torch.float32
                             or bias.shape != (2,)):
        raise ValueError("fused_update: bias must be a float32 (2,) tensor "
                         f"on {params[0].device}")
    index = params[0].get_device()
    if index < 0:
        raise ValueError(f"fused_update: param leaf 0 is on "
                         f"{params[0].device}, expected CPU or CUDA")
    shapes = tuple(map(_shape_of, params))
    plan = _plan_for(optimizer, grad_dtype, compute is not None, shapes,
                     index)
    with plan.lock:
        plan.bind("p", "param", params, torch.float32, shapes)
        plan.bind("g", "grads", grads, grad_dtype)
        for j, leaves in enumerate(state):
            plan.bind(("s1", "s2")[j], f"state[{j}]", leaves, torch.float32)
        if compute is not None:
            plan.bind("pc", "compute", compute, torch.bfloat16)
        if plan.launch is None:
            plan.launch = _library().fused_update
        call = plan.call
        call.lr = lr
        call.bias = None if bias is None else bias.data_ptr()
        call.gate = None if gate is None else gate.data_ptr()
        call.gate_bytes = 0 if gate is None else gate.element_size()
        if plan.index == torch._C._cuda_getDevice():
            call.stream = torch._C._cuda_getCurrentRawStream(plan.index)
            err = plan.launch(plan.address)
        else:
            with torch.cuda.device(plan.index):
                call.stream = torch._C._cuda_getCurrentRawStream(plan.index)
                err = plan.launch(plan.address)
        launched = call.launched
    if err != 0:
        raise RuntimeError(f"fused_update kernel launch failed: CUDA error "
                           f"{err}")
    launch_counts["fused_update"] += launched


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
