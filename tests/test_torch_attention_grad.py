"""The port's attention gradients against the JAX package's, on the CPU.

On CPU tensors ``flash_attention`` goes through the port's autograd
Function with the plain versions of the kernels (``_plain_forward``,
``_plain_dq``, ``_plain_dkv``). The JAX side differentiates its own
``flash_attention``: the Pallas kernels in interpret mode
(``use_pallas=True``, its custom VJP through ``_flash_bwd_dq_kernel`` /
``_flash_bwd_dkv_kernel``) at T <= 320, and its reference attention by
autodiff at the training replay shape. Inputs and the output cotangent are
drawn with numpy from a seed and handed to both.

Tolerances (absolute, on dq, dk, dv of order 0.1-1):
- float32: 2e-5 — the same f32 products summed in another order;
- bfloat16: 3e-2 + 2^-6 relative — both round dS (and P for dV) to bf16
  before their products and round the outputs to bf16, but at different
  points of the forward (the Pallas kernel rounds unnormalised P, the port
  normalised P), so the two differ by a few bf16 ulps of the largest
  gradient entries.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.ops import attention as jattn
from sharetrade_tpu_torch.ops import attention as tattn

F32_ATOL = 2e-5
BF16_ATOL, BF16_RTOL = 3e-2, 2.0 ** -6


def _inputs(seed, shape, kv_len=None):
    rng = np.random.default_rng(seed)
    kv = shape[:2] + (kv_len or shape[2], shape[3])
    return [rng.standard_normal(s, dtype=np.float32)
            for s in (shape, kv, kv, shape)]


def _jax_grads(q, k, v, g, *, causal, window, use_pallas, dtype=jnp.float32):
    def f(q, k, v):
        return jattn.flash_attention(q, k, v, causal=causal,
                                     local_window=window,
                                     use_pallas=use_pallas)
    def grads(q, k, v, g):
        return jax.vjp(f, q, k, v)[1](g)

    args = [jnp.asarray(x, dtype) for x in (q, k, v, g)]
    return [np.asarray(x.astype(jnp.float32)) for x in jax.jit(grads)(*args)]


def _torch_grads(q, k, v, g, *, causal, window, dtype=torch.float32):
    args = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = tattn.flash_attention(*args, causal=causal, local_window=window)
    grads = torch.autograd.grad(out, args, torch.from_numpy(g).to(dtype))
    return [x.float().numpy() for x in grads]


@pytest.mark.parametrize("seq,head_dim,window", [
    (64, 64, None), (64, 128, 16), (64, 64, 64),
    (300, 64, 16), (300, 128, None),
])
def test_f32_grads_match_jax_kernels(seq, head_dim, window):
    q, k, v, g = _inputs(seq + head_dim, (1, 2, seq, head_dim))
    want = _jax_grads(q, k, v, g, causal=True, window=window,
                      use_pallas=True)
    got = _torch_grads(q, k, v, g, causal=True, window=window)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=0,
                                   err_msg=f"d{name}")


def test_noncausal_cross_attention_grads():
    q, k, v, g = _inputs(5, (2, 2, 100, 64), kv_len=257)
    want = _jax_grads(q, k, v, g, causal=False, window=None, use_pallas=True)
    got = _torch_grads(q, k, v, g, causal=False, window=None)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=0,
                                   err_msg=f"d{name}")


def test_replay_shape_matches_jax_reference_autodiff():
    """The training replay's attention: B 1, H 2, 1,424 ticks, D 128,
    band 201."""
    q, k, v, g = _inputs(11, (1, 2, 1424, 128))
    want = _jax_grads(q, k, v, g, causal=True, window=201, use_pallas=False)
    got = _torch_grads(q, k, v, g, causal=True, window=201)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=F32_ATOL, rtol=0,
                                   err_msg=f"d{name}")


def test_bf16_grads_match_jax_kernels():
    q, k, v, g = _inputs(7, (1, 2, 300, 64))
    want = _jax_grads(q, k, v, g, causal=True, window=16, use_pallas=True,
                      dtype=jnp.bfloat16)
    got = _torch_grads(q, k, v, g, causal=True, window=16,
                       dtype=torch.bfloat16)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(a, b, atol=BF16_ATOL, rtol=BF16_RTOL,
                                   err_msg=f"d{name}")


def test_wrappers_and_function_agree():
    """The autograd Function's backward is the two wrappers on the
    forward's lse and delta = rowsum(dO * O); the plain pair of
    ``reference_attention`` gives the same gradients."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(3, (2, 2, 90, 64)))
    scale = 64 ** -0.5
    out, lse = tattn.flash_fwd(q, k, v, sm_scale=scale, window=20)
    delta = (g * out).sum(-1)
    dq = tattn.flash_bwd_dq(q, k, v, g, lse, delta, sm_scale=scale, window=20)
    dk, dv = tattn.flash_bwd_dkv(q, k, v, g, lse, delta, sm_scale=scale,
                                 window=20)
    for fn in (tattn.flash_attention, tattn.reference_attention):
        args = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*args, causal=True, sm_scale=scale, local_window=20)
        assert o.grad_fn is not None
        grads = torch.autograd.grad(o, args, g)
        for a, b in zip(grads, (dq, dk, dv)):
            torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_no_grad_leaves_the_forward_alone():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4, (1, 2, 40, 64)))
    args = [x.requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out = tattn.flash_attention(*args, local_window=8)
    assert out.grad_fn is None
    with pytest.raises(ValueError, match="flash_attention"):
        tattn.flash_fwd(*args, sm_scale=0.125)


def test_dq_cluster_query_refuses_cpu_tensors():
    """``flash_bwd_dq_cluster`` asks the CUDA launcher; on CPU tensors, where
    ``flash_bwd_dq`` runs its plain version, it raises and builds nothing."""
    q, k, _, _ = (torch.from_numpy(x) for x in _inputs(5, (1, 2, 130, 64)))
    with pytest.raises(ValueError, match="flash_bwd_dq: q is on cpu"):
        tattn.flash_bwd_dq_cluster(q, k, window=20)
    assert "flash_bwd" not in tattn.cuda_build._loaded
