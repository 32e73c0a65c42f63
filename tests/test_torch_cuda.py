"""Card-only tests of the port: the CUDA kernel against its plain version.

Every test needs a CUDA device and skips without one (the kernel has no CPU
mode; the CPU tests hold the plain version against the JAX package). This
file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the reference's
tests.) Tolerances as in ``chip_smoke.py``: float32 ``atol 2e-5``; bfloat16
``atol 4e-3 + rtol 2^-7`` (the kernel rounds P and its output to bf16);
lse ``1e-4``.
"""

import numpy as np
import pytest
import torch

from sharetrade_tpu_torch.ops import attention

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (4e-3, 2.0 ** -7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _qkv(shape, dtype, seed=0, kv_len=None):
    rng = np.random.default_rng(seed)
    kv_shape = shape[:2] + (kv_len or shape[2], shape[3])
    arrays = (rng.standard_normal(shape, dtype=np.float32),
              rng.standard_normal(kv_shape, dtype=np.float32),
              rng.standard_normal(kv_shape, dtype=np.float32))
    return [torch.from_numpy(a).to("cuda", dtype) for a in arrays]


def _check(q, k, v, *, causal, window):
    scale = q.shape[-1] ** -0.5
    attention.reset_launch_counts()
    out, lse = attention.flash_fwd(q, k, v, causal=causal, sm_scale=scale,
                                   window=window)
    assert attention.launch_counts["flash_fwd"] == 1
    ref, ref_lse = attention._plain_forward(q.float(), k.float(), v.float(),
                                            causal, scale, window)
    atol, rtol = TOL[q.dtype]
    assert out.dtype == q.dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref, atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window", [
    ((4, 2, 401, 128), 201),     # the serving shape class
    ((1, 2, 1000, 128), 201),    # several band tiles per query tile
    ((2, 3, 130, 64), None),     # plain causal, ragged tiles
    ((1, 1, 23, 64), 12),        # shorter than one tile
])
def test_kernel_matches_plain(cuda, dtype, shape, window):
    q, k, v = _qkv(shape, dtype, seed=shape[2])
    _check(q, k, v, causal=True, window=window)


def test_noncausal_cross_attention(cuda):
    q, k, v = _qkv((2, 2, 100, 64), torch.float32, kv_len=257)
    _check(q, k, v, causal=False, window=None)


def test_fully_masked_rows_give_zero(cuda):
    q, k, v = _qkv((1, 2, 70, 128), torch.float32)
    out, lse = attention.flash_fwd(q, k, v, causal=True, sm_scale=0.1,
                                   window=0)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.equal(lse, torch.zeros_like(lse))


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv((1, 1, 16, 64), torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros((1, 1, 16, 32), device="cuda")
        attention.flash_fwd(x, x, x, sm_scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_fwd(q.transpose(2, 3), k.transpose(2, 3),
                            v.transpose(2, 3), sm_scale=1.0)
    with pytest.raises(ValueError, match="dtype"):
        attention.flash_fwd(q.half(), k.half(), v.half(), sm_scale=1.0)
    with pytest.raises(NotImplementedError, match="training slice"):
        attention.flash_fwd(q.requires_grad_(), k, v, sm_scale=1.0)


def test_model_prefill_through_kernel_matches_plain(cuda):
    """The episode model's prefill on the card: kernel attention against
    the plain attention, fp32, and one launch per layer."""
    from sharetrade_tpu_torch.models.transformer_episode import (
        episode_transformer_policy)

    def plain(q, k, v, w):
        return attention.reference_attention(q, k, v, causal=True,
                                             sm_scale=64 ** -0.5,
                                             local_window=w)

    kw = dict(num_layers=2, num_heads=2, head_dim=64, device=cuda)
    model = episode_transformer_policy(14, 3, **kw)
    ref_model = episode_transformer_policy(14, 3, attention_fn=plain, **kw)
    params = model.init(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    prices = 50 * np.exp(np.cumsum(rng.uniform(-0.03, 0.03, (3, 12)), 1))
    obs = torch.from_numpy(np.concatenate(
        [prices, np.full((3, 2), 5.0)], 1).astype(np.float32)).to(cuda)
    attention.reset_launch_counts()
    with torch.inference_mode():
        got, carry = model.apply_prefill(params, obs)
        want, ref_carry = ref_model.apply_prefill(params, obs)
    assert attention.launch_counts["flash_fwd"] == 2
    torch.testing.assert_close(got.logits, want.logits, atol=1e-5, rtol=0)
    torch.testing.assert_close(got.value, want.value, atol=1e-5, rtol=0)
    torch.testing.assert_close(carry["k"], ref_carry["k"], atol=1e-4, rtol=0)
