"""Causal / banded multi-head attention: a CUDA flash kernel and its plain
PyTorch version.

Counterpart of the JAX package's ``ops/attention.py`` (forward only). Shapes
are ``(batch, heads, seq, head_dim)`` throughout, as there.

- :func:`flash_attention` is the public entry: the JAX package's argument
  rules (``local_window >= T`` means plain causal, ``local_window < 1`` and a
  band without ``causal`` are refused, causal needs equal q/kv lengths).
- :func:`flash_fwd` is the kernel wrapper. On a CUDA tensor it launches the
  hand-written kernel ``csrc/flash_fwd.cu`` (built at first use) or raises;
  on a CPU tensor it computes the plain version. There is no fallback
  between the two.
- :func:`reference_attention` is the plain version: dense scores in float32,
  masked softmax, probabilities cast to the input dtype before the product
  with V, as the JAX reference computes it. Unlike the JAX reference, a row
  that sees no key gives 0 (and lse 0) rather than a uniform average — the
  same answer the kernel gives.

Gradients: the backward kernels (the JAX package's K3-K6) come with the
training slice; a CUDA input that requires grad is refused.
"""

from __future__ import annotations

import ctypes

import torch

from sharetrade_tpu_torch.config import ConfigError
from sharetrade_tpu_torch.ops import cuda_build

#: Kernel launches per wrapper, counted where the kernel is launched and
#: nowhere else (``chip_smoke.py`` reads them to prove the main path ran
#: through the kernel). Reset with :func:`reset_launch_counts`.
launch_counts: dict[str, int] = {"flash_fwd": 0}

_HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _plain_forward(q, k, v, causal: bool, sm_scale: float,
                   window: int | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense masked attention; returns ``(out, lse)``. Scores, softmax and
    lse in float32; the normalised probabilities are cast to ``q``'s dtype
    before the product with ``v``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * sm_scale
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        row = torch.arange(t_q, device=s.device)[:, None]
        col = torch.arange(t_k, device=s.device)[None, :]
        mask = col <= row
        if window is not None:
            mask = mask & (col > row - window)
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


def reference_attention(q, k, v, *, causal: bool = True,
                        sm_scale: float | None = None,
                        local_window: int | None = None) -> torch.Tensor:
    """Plain PyTorch attention — the numeric ground truth for the kernel.
    ``local_window=W`` restricts query row p to keys ``(p-W, p]``."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if local_window is not None and not causal:
        raise ConfigError("local_window requires causal attention")
    return _plain_forward(q, k, v, causal, sm_scale, local_window)[0]


def _kernel_library() -> ctypes.CDLL:
    lib = cuda_build.load("flash_fwd")
    fn = lib.flash_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_kernel_inputs(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_fwd: {name} is on {t.device}, expected "
                             f"the CUDA device of q ({q.device})")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_fwd: {name} is {t.dtype}, q is {q.dtype}")
        if t.ndim != 4:
            raise ValueError(f"flash_fwd: {name} must be (batch, heads, seq, "
                             f"head_dim), got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"flash_fwd: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_fwd: {name} must be 16-byte aligned")
        if t.requires_grad:
            raise NotImplementedError(
                "flash backward is ported with the training slice")
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_fwd: dtype {q.dtype} unsupported; the "
                         f"kernel takes {sorted(map(str, _DTYPE_CODES))}")
    batch, heads, _, head_dim = q.shape
    if head_dim not in _HEAD_DIMS:
        raise ValueError(f"flash_fwd: head_dim {head_dim} unsupported; the "
                         f"kernel is built for {_HEAD_DIMS}")
    if k.shape != v.shape or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != head_dim:
        raise ValueError(f"flash_fwd: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} disagree")
    if batch * heads > 65535:
        raise ValueError(f"flash_fwd: batch*heads = {batch * heads} exceeds "
                         "the grid's 65535")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: float,
              window: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Flash-attention forward: ``(out (B,H,Tq,D) in q's dtype, lse (B,H,Tq)
    float32)``. ``window`` bands a causal mask to keys ``(row-window, row]``
    (0 masks every key). CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    if q.device.type == "cpu":
        return _plain_forward(q, k, v, causal, sm_scale, window)
    _check_kernel_inputs(q, k, v)
    batch, heads, t_q, head_dim = q.shape
    t_k = k.shape[2]
    if causal and t_k != t_q:
        raise ValueError(f"flash_fwd: causal needs q_len == kv_len, got "
                         f"{t_q} vs {t_k}")
    if window is not None and window < 0:
        raise ValueError(f"flash_fwd: window must be >= 0, got {window}")
    band = (t_q + t_k) if window is None else window
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, t_q), dtype=torch.float32,
                      device=q.device)
    lib = _kernel_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), batch * heads, t_q, t_k, head_dim,
            _DTYPE_CODES[q.dtype], int(causal), band, float(sm_scale),
            stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error {err}")
    launch_counts["flash_fwd"] += 1
    return out, lse


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    local_window: int | None = None) -> torch.Tensor:
    """Causal (optionally banded) MHA over (batch, heads, seq, head_dim).

    ``local_window=W`` restricts each query to the W keys ending at itself;
    the kernel visits only the key tiles inside that band, so the cost is
    O(T·W) rather than O(T²)."""
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
    out, _ = flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                       causal=causal, sm_scale=sm_scale, window=local_window)
    return out
