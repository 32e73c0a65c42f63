"""Causal / banded multi-head attention: CUDA flash kernels, their plain
PyTorch versions, and the autograd glue.

Counterpart of the JAX package's ``ops/attention.py``. Shapes are ``(batch,
heads, seq, head_dim)`` throughout, as there.

- :func:`flash_attention` is the public entry: the JAX package's argument
  rules (``local_window >= T`` means plain causal, ``local_window < 1`` and a
  band without ``causal`` are refused, causal needs equal q/kv lengths).
  When an input requires grad (and grad mode is on) it goes through
  :class:`_Attention`, a ``torch.autograd.Function`` that saves
  ``(q, k, v, out, lse)`` and whose backward runs the backward kernels;
  otherwise (serving, ``no_grad``, ``inference_mode``) it calls the forward
  wrapper alone.
- :func:`flash_fwd`, :func:`flash_bwd_dq` and :func:`flash_bwd_dkv` are the
  kernel wrappers. On CUDA tensors they launch the hand-written kernels
  ``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (built at first use) or
  raise; on CPU tensors they compute the plain versions. There is no
  fallback between the two. :func:`flash_bwd_dq_cluster` reports over how
  many blocks of a thread-block cluster ``flash_bwd_dq`` splits each query
  tile's key loop.
- The plain versions: :func:`_plain_forward` (dense scores in float32,
  masked softmax, probabilities cast to the input dtype before the product
  with V) and :func:`_plain_backward` (the same recomputation of P from lse,
  with the kernels' rounding points: dS rounded to the input dtype before
  dS·K and dSᵀ·Q, P rounded to dO's dtype before Pᵀ·dO). A row that sees no
  key gives 0 (and lse 0) and no gradient, as the kernels do; the JAX
  reference averages V uniformly there (no valid call produces such a row).
  :func:`reference_attention` is the plain pair as a differentiable
  function, on any device.

``δ = rowsum(dO ∘ O)`` is computed in float32 outside the kernels, as the
JAX package's ``_flash_backward`` does.

The kernels are built for head_dim 64 and 128. A narrower head (any width
up to 128) is zero-padded to the next built width before a launch and the
padding sliced off O, dQ, dK and dV after it, as the JAX wrappers pad to a
lane multiple: zero lanes leave QKᵀ, the log-sum-exp and δ unchanged, and
``sm_scale`` stays that of the unpadded width. A head wider than 128 is
refused on the card (``models/__init__.py`` at ``build_model``).
"""

from __future__ import annotations

import ctypes

import torch

from sharetrade_tpu_torch.config import ConfigError
from sharetrade_tpu_torch.ops import cuda_build

#: Kernel launches per wrapper, counted where the kernel is launched and
#: nowhere else (``chip_smoke.py`` reads them to prove the main path ran
#: through the kernels). Reset with :func:`reset_launch_counts`.
launch_counts: dict[str, int] = {"flash_fwd": 0, "flash_bwd_dq": 0,
                                 "flash_bwd_dkv": 0}

_HEAD_DIMS = (64, 128)
#: The widest head the kernels take (narrower ones are padded up).
MAX_HEAD_DIM = _HEAD_DIMS[-1]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _visible(t_q: int, t_k: int, causal: bool, window: int | None,
             device) -> torch.Tensor | None:
    """(t_q, t_k) bool mask of the keys each row sees (None: all)."""
    if not causal:
        return None
    row = torch.arange(t_q, device=device)[:, None]
    col = torch.arange(t_k, device=device)[None, :]
    mask = col <= row
    if window is not None:
        mask = mask & (col > row - window)
    return mask


def _plain_forward(q, k, v, causal: bool, sm_scale: float,
                   window: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense masked attention; returns ``(out, lse)``. Scores, softmax and
    lse in float32; the normalised probabilities are cast to ``q``'s dtype
    before the product with ``v``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    mask = _visible(s.shape[-2], s.shape[-1], causal, window, s.device)
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    seen = l > 0
    probs = (p / torch.where(seen, l, torch.ones_like(l))).to(q.dtype)
    out = torch.matmul(probs, v)
    lse = torch.where(seen, m + torch.log(l), torch.zeros_like(l))
    return out, lse[..., 0]


def _plain_probs(q, k, lse, causal, sm_scale, window) -> torch.Tensor:
    """P = exp(q·k·scale - lse) over the visible keys, 0 elsewhere (f32)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    p = torch.exp(s - lse[..., None])
    mask = _visible(s.shape[-2], s.shape[-1], causal, window, s.device)
    if mask is not None:
        p = torch.where(mask, p, torch.zeros_like(p))
    return p


def _plain_ds(q, k, v, dout, lse, delta, causal, sm_scale, window):
    """(P f32, dS rounded to the input dtype)."""
    p = _plain_probs(q, k, lse, causal, sm_scale, window)
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None]) * sm_scale).to(q.dtype)
    return p, ds


def _plain_dq(q, k, v, dout, lse, delta, causal, sm_scale, window):
    _p, ds = _plain_ds(q, k, v, dout, lse, delta, causal, sm_scale, window)
    return torch.matmul(ds.float(), k.float()).to(q.dtype)


def _plain_dkv(q, k, v, dout, lse, delta, causal, sm_scale, window):
    p, ds = _plain_ds(q, k, v, dout, lse, delta, causal, sm_scale, window)
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      dout.float()).to(v.dtype)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float()).to(k.dtype)
    return dk, dv


def _plain_backward(q, k, v, dout, lse, delta, causal: bool, sm_scale: float,
                    window: int | None):
    """``(dq, dk, dv)`` in the inputs' dtypes; see the module docstring."""
    dq = _plain_dq(q, k, v, dout, lse, delta, causal, sm_scale, window)
    dk, dv = _plain_dkv(q, k, v, dout, lse, delta, causal, sm_scale, window)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _library(name: str) -> ctypes.CDLL:
    """The built ``csrc/<name>.cu`` with every entry point's signature set:
    pointers and the stream as ``c_void_p``, ints, ``sm_scale`` a float."""
    lib = cuda_build.load(name)
    signatures = {
        "flash_fwd": ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                      + [ctypes.c_float, ctypes.c_void_p]),
        "flash_bwd_dq": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                         + [ctypes.c_float, ctypes.c_void_p]),
        "flash_bwd_dkv": ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                          + [ctypes.c_float, ctypes.c_void_p]),
        "flash_bwd_dq_cluster": ([ctypes.c_int] * 7
                                 + [ctypes.POINTER(ctypes.c_int)]),
    }
    for fn_name, argtypes in signatures.items():
        if hasattr(lib, fn_name):
            fn = getattr(lib, fn_name)
            if fn.argtypes is None:
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(name: str, q, k, v, *extra) -> None:
    for label, t in (("q", q), ("k", k), ("v", v)) + extra:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {label} is on {t.device}, expected "
                             f"the CUDA device of q ({q.device})")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: {label} is {t.dtype}, q is {q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"{name}: {label} must be (batch, heads, seq, "
                             f"head_dim), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: dtype {q.dtype} unsupported; the "
                         f"kernel takes {sorted(map(str, _DTYPE_CODES))}")
    batch, heads, _, head_dim = q.shape
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {head_dim} unsupported; the "
                         f"kernel is built for {_HEAD_DIMS}")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != head_dim:
        raise ValueError(f"{name}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} disagree")
    if batch * heads > 65535:
        raise ValueError(f"{name}: batch*heads = {batch * heads} exceeds "
                         "the grid's 65535")


def _check_args(name: str, q, k, causal: bool, window: int | None) -> int:
    """Validate the shared arguments; returns the band the kernels take."""
    t_q, t_k = q.shape[2], k.shape[2]
    if causal and t_k != t_q:
        raise ValueError(f"{name}: causal needs q_len == kv_len, got "
                         f"{t_q} vs {t_k}")
    if window is not None and window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    return (t_q + t_k) if window is None else window


def _check_rows(name: str, q, **rows) -> None:
    """lse / delta: (B, H, Tq) float32, contiguous, on q's device."""
    for label, t in rows.items():
        if t.shape != q.shape[:3] or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be a contiguous float32 "
                             f"{tuple(q.shape[:3])} tensor on {q.device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _built_width(head_dim: int) -> int:
    """The narrowest built kernel width that holds ``head_dim``."""
    for width in _HEAD_DIMS:
        if head_dim <= width:
            return width
    raise ValueError(f"head_dim {head_dim} unsupported: the kernels are "
                     f"built for {_HEAD_DIMS} and pad narrower heads up")


def _pad_lanes(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with its last dim zero-padded to ``width``, contiguous."""
    return torch.nn.functional.pad(t, (0, width - t.shape[-1])).contiguous()


def _padded(wrapper, q, k, v, *rest, **kw):
    """``wrapper`` (a kernel wrapper) on q, k, v (and dO, first of
    ``rest``, for the backward) zero-padded from head_dim to the next built
    width, with the padding sliced off its (B, H, T, D) outputs; lse and δ
    (the rest) pass as they are."""
    head_dim = q.shape[-1]
    width = _built_width(head_dim)
    padded = [_pad_lanes(t, width) for t in (q, k, v)]
    if rest:
        rest = (_pad_lanes(rest[0], width),) + tuple(rest[1:])
    out = wrapper(*padded, *rest, **kw)

    def unpad(t):
        return t[..., :head_dim].contiguous()

    if wrapper is flash_fwd:
        return unpad(out[0]), out[1]
    if isinstance(out, tuple):
        return tuple(unpad(t) for t in out)
    return unpad(out)


def _launch(name: str, fn, *args) -> None:
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launch_counts[name] += 1


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: float,
              window: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: ``(out (B,H,Tq,D) in q's dtype, lse (B,H,Tq)
    float32)``. ``window`` bands a causal mask to keys ``(row-window, row]``
    (0 masks every key). CUDA tensors launch the kernel; CPU tensors take
    the plain version. Gives no gradient: an input that requires grad under
    grad mode is refused (``flash_attention`` differentiates)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_fwd gives no gradient; call flash_attention "
                         "to differentiate through the kernels")
    if q.device.type == "cpu":
        return _plain_forward(q, k, v, causal, sm_scale, window)
    if q.shape[-1] not in _HEAD_DIMS:
        return _padded(flash_fwd, q, k, v, causal=causal, sm_scale=sm_scale,
                       window=window)
    _check_kernel_inputs("flash_fwd", q, k, v)
    band = _check_args("flash_fwd", q, k, causal, window)
    batch, heads, t_q, head_dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, t_q), dtype=torch.float32,
                      device=q.device)
    _launch("flash_fwd", _library("flash_fwd").flash_fwd, q, k, v, out, lse,
            batch * heads, t_q, k.shape[2], head_dim, _DTYPE_CODES[q.dtype],
            int(causal), band, float(sm_scale))
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = True,
                 sm_scale: float, window: int | None = None) -> torch.Tensor:
    """dQ of flash attention in q's dtype, from the forward's ``lse`` and
    ``delta = rowsum(dO∘O)`` (float32). CUDA tensors launch
    ``flash_bwd_dq``; CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return _plain_dq(q, k, v, dout, lse, delta, causal, sm_scale, window)
    if q.shape[-1] not in _HEAD_DIMS:
        return _padded(flash_bwd_dq, q, k, v, dout, lse, delta, causal=causal,
                       sm_scale=sm_scale, window=window)
    _check_kernel_inputs("flash_bwd_dq", q, k, v, ("dout", dout))
    _check_rows("flash_bwd_dq", q, lse=lse, delta=delta)
    band = _check_args("flash_bwd_dq", q, k, causal, window)
    if dout.shape != q.shape:
        raise ValueError(f"flash_bwd_dq: dout{tuple(dout.shape)} must match "
                         f"q{tuple(q.shape)}")
    batch, heads, t_q, head_dim = q.shape
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", _library("flash_bwd").flash_bwd_dq, q, k, v,
            dout, lse, delta, dq, batch * heads, t_q, k.shape[2], head_dim,
            _DTYPE_CODES[q.dtype], int(causal), band, float(sm_scale))
    return dq


def flash_bwd_dq_cluster(q, k, *, causal: bool = True,
                         window: int | None = None) -> int:
    """Blocks of the thread-block cluster over which :func:`flash_bwd_dq`
    splits each query tile's key loop for these CUDA inputs (1 or 2; 1 for
    float32). Launches nothing."""
    if q.shape[-1] not in _HEAD_DIMS:
        width = _built_width(q.shape[-1])
        q, k = _pad_lanes(q, width), _pad_lanes(k, width)
    _check_kernel_inputs("flash_bwd_dq", q, k, k)
    band = _check_args("flash_bwd_dq", q, k, causal, window)
    batch, heads, t_q, head_dim = q.shape
    cluster = ctypes.c_int(0)
    with torch.cuda.device(q.device):
        err = _library("flash_bwd").flash_bwd_dq_cluster(
            batch * heads, t_q, k.shape[2], head_dim, _DTYPE_CODES[q.dtype],
            int(causal), band, ctypes.byref(cluster))
    if err != 0:
        raise RuntimeError(f"flash_bwd_dq_cluster failed: CUDA error {err}")
    return cluster.value


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = True,
                  sm_scale: float, window: int | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(dK, dV)`` of flash attention in k's/v's dtype. CUDA tensors
    launch ``flash_bwd_dkv``; CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return _plain_dkv(q, k, v, dout, lse, delta, causal, sm_scale, window)
    if q.shape[-1] not in _HEAD_DIMS:
        return _padded(flash_bwd_dkv, q, k, v, dout, lse, delta,
                       causal=causal, sm_scale=sm_scale, window=window)
    _check_kernel_inputs("flash_bwd_dkv", q, k, v, ("dout", dout))
    _check_rows("flash_bwd_dkv", q, lse=lse, delta=delta)
    band = _check_args("flash_bwd_dkv", q, k, causal, window)
    if dout.shape != q.shape:
        raise ValueError(f"flash_bwd_dkv: dout{tuple(dout.shape)} must match "
                         f"q{tuple(q.shape)}")
    batch, heads, t_q, head_dim = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", _library("flash_bwd").flash_bwd_dkv, q, k, v,
            dout, lse, delta, dk, dv, batch * heads, t_q, k.shape[2],
            head_dim, _DTYPE_CODES[q.dtype], int(causal), band,
            float(sm_scale))
    return dk, dv


# ---------------------------------------------------------------------------
# autograd glue and the public entries
# ---------------------------------------------------------------------------

class _Attention(torch.autograd.Function):
    """Attention with a hand-written backward: the kernel wrappers
    (``plain=False``) or the plain versions on any device (``plain=True``,
    the yardstick ``chip_smoke.py`` holds the kernels against)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale, window, plain):
        if plain:
            out, lse = _plain_forward(q, k, v, causal, sm_scale, window)
        else:
            out, lse = flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                                 window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, sm_scale, window, plain)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, sm_scale, window, plain = ctx.args
        dout = dout.contiguous()
        delta = (dout.float() * out.float()).sum(dim=-1)
        if plain:
            dq, dk, dv = _plain_backward(q, k, v, dout, lse, delta, causal,
                                         sm_scale, window)
        else:
            kw = dict(causal=causal, sm_scale=sm_scale, window=window)
            dq = flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
            dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
        return dq, dk, dv, None, None, None, None


def _resolve(q, k, causal: bool, sm_scale: float | None,
             local_window: int | None) -> tuple[float, int | None]:
    """The JAX package's argument rules; returns (sm_scale, window)."""
    if q.ndim != 4:
        raise ConfigError(f"expected (batch, heads, seq, head_dim), got "
                          f"{tuple(q.shape)}")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if local_window is not None:
        if not causal:
            raise ConfigError("local_window requires causal attention")
        if local_window < 1:
            raise ConfigError(f"local_window must be >= 1, got {local_window}")
        if local_window >= q.shape[2]:
            local_window = None     # band covers everything: plain causal
    if causal and k.shape[2] != q.shape[2]:
        raise ConfigError(f"causal attention requires q_len == kv_len, got "
                          f"{q.shape[2]} vs {k.shape[2]}")
    return sm_scale, local_window


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    local_window: int | None = None) -> torch.Tensor:
    """Causal (optionally banded) MHA over (batch, heads, seq, head_dim).

    ``local_window=W`` restricts each query to the W keys ending at itself;
    the kernels visit only the tiles inside that band, so the cost is
    O(T·W) rather than O(T²). Differentiable through the backward kernels."""
    sm_scale, window = _resolve(q, k, causal, sm_scale, local_window)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, sm_scale, window, False)
    return flash_fwd(q, k, v, causal=causal, sm_scale=sm_scale,
                     window=window)[0]


def reference_attention(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None,
                        local_window: int | None = None) -> torch.Tensor:
    """Plain PyTorch attention — the numeric ground truth for the kernels,
    on any device, differentiable through the plain backward.
    ``local_window=W`` restricts query row p to keys ``(p-W, p]``."""
    if local_window is not None and not causal:
        raise ConfigError("local_window requires causal attention")
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, causal, sm_scale, local_window, True)
    return _plain_forward(q, k, v, causal, sm_scale, local_window)[0]
