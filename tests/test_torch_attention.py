"""The port's attention (sharetrade_tpu_torch.ops.attention) against the JAX
package's, on the CPU.

On the CPU the port's ``flash_attention`` computes its plain version; the
JAX side runs its Pallas flash kernel in interpret mode
(``use_pallas=True``, as tests/test_ops.py does) and its
``reference_attention``. Inputs are drawn with numpy from a seed and handed
to both.

Tolerances:
- float32: ``atol 1e-5`` on outputs and lse — the same f32 products, summed
  in another order (online vs dense softmax).
- bfloat16: ``atol 2e-2 + rtol 2^-7`` on outputs. The port rounds the
  normalised probabilities to bf16 and the product's output to bf16; the
  Pallas kernel rounds the unnormalised probabilities and normalises in
  f32. Each output is a bf16 rounding (half an ulp is 2^-9 relative) of a
  weighted mean of bf16 values, so two bf16 roundings apart at most a few
  ulps of the largest V entries.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sharetrade_tpu.ops import attention as jattn
from sharetrade_tpu_torch.config import ConfigError
from sharetrade_tpu_torch.ops import attention as tattn

F32_ATOL = 1e-5
BF16_ATOL = 2e-2
BF16_RTOL = 2.0 ** -7


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]


def _resolve(window, t):
    return t + 5 if window == "T" else window


@pytest.mark.parametrize("window", [None, 16, 201, "T"])
@pytest.mark.parametrize("head_dim", [64, 128])
@pytest.mark.parametrize("seq", [64, 300, 401])
def test_f32_matches_jax_kernel_and_reference(seq, head_dim, window):
    window = _resolve(window, seq)
    q, k, v = _qkv(seq * 7 + head_dim, (1, 2, seq, head_dim))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jkern = np.asarray(jattn.flash_attention(
        jq, jk, jv, causal=True, local_window=window, use_pallas=True))
    jref = np.asarray(jattn.reference_attention(
        jq, jk, jv, causal=True,
        local_window=window if window and window < seq else None))
    got = tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, local_window=window).numpy()
    np.testing.assert_allclose(got, jkern, atol=F32_ATOL, rtol=0)
    np.testing.assert_allclose(got, jref, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("seq,window", [(401, 201), (300, 16), (64, None)])
def test_lse_matches_jax_kernel(seq, window):
    """The kernel-level (out, lse) pair against the Pallas forward's."""
    head_dim = 128
    q, k, v = _qkv(seq, (2, 1, seq, head_dim))
    scale = head_dim ** -0.5
    jout, jlse = jattn._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, scale, window,
        True)
    out, lse = tattn.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               sm_scale=scale, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=F32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=F32_ATOL,
                               rtol=0)


@pytest.mark.parametrize("seq,window", [(401, 201), (64, None)])
def test_bf16_matches_jax(seq, window):
    q, k, v = (x.astype(jnp.bfloat16) for x in _qkv(seq + 1,
                                                     (2, 2, seq, 128)))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jkern = np.asarray(jattn.flash_attention(
        jq, jk, jv, causal=True, local_window=window,
        use_pallas=True).astype(jnp.float32))
    jref = np.asarray(jattn.reference_attention(
        jq, jk, jv, causal=True, local_window=window).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16) for x in (q, k, v))
    got = tattn.flash_attention(tq, tk, tv, causal=True,
                                local_window=window)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    for want in (jkern, jref):
        np.testing.assert_allclose(got, want, atol=BF16_ATOL,
                                   rtol=BF16_RTOL)


def test_long_banded_matches_reference():
    """T = 4200 at D = 128 is past the JAX package's streaming threshold
    (kv_pad * d_pad > 2^19), where its kernel switches to K2."""
    seq, window = 4200, 201
    assert 4352 * 128 > jattn._STREAM_KV_ELEMS
    q, k, v = _qkv(4200, (1, 1, seq, 128))
    want = np.asarray(jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        local_window=window))
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True,
                                local_window=window).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_fully_masked_rows_give_zero_and_zero_lse():
    """A band of width 0 leaves every row without a visible key: the plain
    version emits 0 and lse 0 (no NaN from an empty softmax), as the kernel
    does (tests/test_torch_cuda.py). A band of width 1 sees the diagonal."""
    q, k, v = map(torch.from_numpy, _qkv(3, (1, 2, 40, 64)))
    out, lse = tattn.flash_fwd(q, k, v, causal=True, sm_scale=0.125,
                               window=0)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.equal(lse, torch.zeros_like(lse))
    out1, lse1 = tattn.flash_fwd(q, k, v, causal=True, sm_scale=0.125,
                                 window=1)
    # Band 1: each row sees only itself, so out = v and lse = s_rr.
    np.testing.assert_allclose(out1.numpy(), v.numpy(), atol=F32_ATOL)
    diag = (q * k).sum(-1) * 0.125
    np.testing.assert_allclose(lse1.numpy(), diag.numpy(), atol=F32_ATOL)


def test_noncausal_cross_attention_matches_reference():
    q, _, _ = _qkv(5, (1, 2, 48, 64))
    _, k, v = _qkv(6, (1, 2, 80, 64))
    want = np.asarray(jattn.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False))
    got = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=False).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_argument_rules():
    q = torch.zeros((1, 1, 8, 64))
    with pytest.raises(ConfigError):
        tattn.flash_attention(q, q, q, causal=True, local_window=0)
    with pytest.raises(ConfigError):
        tattn.flash_attention(q, q, q, causal=False, local_window=4)
    with pytest.raises(ConfigError):
        tattn.flash_attention(q[0], q[0], q[0])
    with pytest.raises(ConfigError):
        tattn.flash_attention(q, torch.zeros((1, 1, 9, 64)),
                              torch.zeros((1, 1, 9, 64)), causal=True)
    # A band covering the sequence is plain causal attention.
    x, y, z = map(torch.from_numpy, _qkv(9, (1, 2, 8, 64)))
    assert torch.equal(tattn.flash_attention(x, y, z, local_window=8),
                       tattn.flash_attention(x, y, z))


def test_cpu_tensors_never_count_a_launch():
    tattn.reset_launch_counts()
    x = torch.zeros((1, 1, 8, 64))
    tattn.flash_attention(x, x, x, local_window=4)
    assert tattn.launch_counts["flash_fwd"] == 0


@pytest.mark.parametrize("head_dim", [16, 32, 96])
def test_narrow_heads_pad_to_the_built_width(head_dim):
    """A head narrower than the built widths goes to the kernel wrappers
    zero-padded to 64 or 128, the padding sliced off O, dQ, dK and dV. The
    same padding helper the CUDA path takes, driven here over the CPU
    wrappers (the plain versions), against the JAX flash kernel (interpret
    mode) and the unpadded plain versions; f32, ``F32_ATOL``."""
    seq, window = 80, 33
    scale = head_dim ** -0.5
    q, k, v = map(torch.from_numpy, _qkv(head_dim, (2, 2, seq, head_dim)))
    dout = torch.from_numpy(_qkv(head_dim + 1, (2, 2, seq, head_dim))[0])
    kw = dict(causal=True, sm_scale=scale, window=window)
    out, lse = tattn._padded(tattn.flash_fwd, q, k, v, **kw)
    want, want_lse = tattn.flash_fwd(q, k, v, **kw)
    assert out.shape == q.shape and out.is_contiguous()
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=F32_ATOL,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=F32_ATOL,
                               rtol=0)
    jkern = np.asarray(jattn.flash_attention(
        *map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())), causal=True,
        local_window=window, use_pallas=True))
    np.testing.assert_allclose(out.numpy(), jkern, atol=F32_ATOL, rtol=0)
    delta = (dout * out).sum(dim=-1)
    dq = tattn._padded(tattn.flash_bwd_dq, q, k, v, dout, lse, delta, **kw)
    dk, dv = tattn._padded(tattn.flash_bwd_dkv, q, k, v, dout, lse, delta,
                           **kw)
    want_dq = tattn.flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
    want_dk, want_dv = tattn.flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    for got, ref in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert got.shape == q.shape
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=F32_ATOL,
                                   rtol=0)
    assert tattn._built_width(head_dim) == (64 if head_dim <= 64 else 128)


def test_heads_wider_than_the_kernels_are_refused_on_cuda(monkeypatch):
    """head_dim > 128: the kernels cannot take it, so ``build_model``
    refuses it for the card before building anything (the device is only
    named here, no GPU is touched); the CPU path runs any width."""
    from sharetrade_tpu_torch import models
    from sharetrade_tpu_torch.config import ModelConfig

    cfg = ModelConfig(kind="transformer", seq_mode="episode", num_layers=1,
                      num_heads=1, head_dim=160)
    with pytest.raises(ValueError, match="unsupported"):
        tattn._built_width(160)
    monkeypatch.setattr(models, "resolve_device",
                        lambda device: torch.device("cuda"))
    with pytest.raises(ConfigError, match="head_dim=160"):
        models.build_model(cfg, 10)
    monkeypatch.undo()
    assert models.build_model(cfg, 10, device="cpu").name
