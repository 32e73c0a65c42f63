"""Card-only tests of the port: the CUDA kernels against their plain
versions.

Every test needs a CUDA device and skips without one (the kernels have no
CPU mode; the CPU tests hold the plain versions against the JAX package).
This file imports nothing of JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the reference's
tests.) Tolerances as in ``chip_smoke.py``: forward float32 ``atol 2e-5``,
bfloat16 ``atol 4e-3 + rtol 2^-7`` (the kernel rounds P and its output to
bf16), lse ``1e-4``; backward float32 ``atol 5e-5 + rtol 1e-5`` against the
float32 reference, bfloat16 at most twice the plain bf16 backward's own
largest error against that reference, plus ``1e-3`` (the kernels make the
TPU kernels' bf16 roundings of dS and P, which alone move a gradient by
~1e-2 on unit-scale inputs); fused update ``atol 1e-6 + rtol 1e-6``, its
bf16 compute copy exact, and gated off or on bit-equal to the unchanged
state or the ungated update; one PPO minibatch as ``chip_smoke.py`` holds the
flagship's (``MB_FACTOR`` there): against the fp32 model, the kernel path's
error at most twice the plain bf16 path's plus 2^-8 of the reference's
size, and the policy term within the bound its formula gives.
Checkpoints on the card: a CUDA generator's state and every leaf round-trip
bit for bit, and ``save_async``'s pinned side-stream copy holds the bits of
the state it was handed while the caller's stream updates it in place.
Serving on the card: the flagship engine takes live knobs mid-load, and
the online controller tightens, then relaxes, never past config.
"""

import numpy as np
import pytest
import torch

from sharetrade_tpu_torch.ops import attention

pytestmark = pytest.mark.cuda

TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (4e-3, 2.0 ** -7)}


@pytest.fixture(autouse=True)
def _full_f32_products():
    """f32 parity needs full f32 matrix products (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
    ((1, 1, 37, 64), None),      # shorter than one tile, plain causal
    ((2, 2, 130, 128), 1),       # each row sees only itself
    ((1, 2, 401, 64), 201),      # the serving band at D = 64
    ((40, 2, 130, 128), None),   # B*H = 80 > 64
])
def test_kernel_matches_plain(cuda, dtype, shape, window):
    q, k, v = _qkv(shape, dtype, seed=shape[2])
    _check(q, k, v, causal=True, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_noncausal_cross_attention(cuda, dtype):
    q, k, v = _qkv((2, 2, 100, 64), dtype, kv_len=257)
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
        x = torch.zeros((1, 1, 16, 160), device="cuda")
        attention.flash_fwd(x, x, x, sm_scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        x = torch.zeros((1, 1, 64, 64), device="cuda").transpose(2, 3)
        attention.flash_fwd(x, x, x, sm_scale=1.0)
    with pytest.raises(ValueError, match="dtype"):
        attention.flash_fwd(q.half(), k.half(), v.half(), sm_scale=1.0)
    # An input that requires grad: the forward wrapper alone would drop the
    # gradient and refuses; flash_attention differentiates through the
    # backward kernels.
    with pytest.raises(ValueError, match="flash_attention"):
        attention.flash_fwd(q.requires_grad_(), k, v, sm_scale=1.0)
    attention.reset_launch_counts()
    out = attention.flash_attention(q, k, v, local_window=4)
    out.sum().backward()
    assert q.grad is not None and q.grad.shape == q.shape
    assert attention.launch_counts == {"flash_fwd": 1, "flash_bwd_dq": 1,
                                       "flash_bwd_dkv": 1}
    with pytest.raises(ValueError, match="delta"):
        attention.flash_bwd_dq(q.detach(), k, v, q.detach(),
                               torch.zeros((1, 1, 16), device="cuda"),
                               torch.zeros((1, 1, 15), device="cuda"),
                               sm_scale=1.0)


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


def _bwd_inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32) for _ in range(4)]
    return [torch.from_numpy(a).to("cuda", dtype) for a in arrays]


def _check_backward(q, k, v, dout, *, causal, window):
    """Both backward kernels, one launch each, against the plain backward
    in float32 (float32: atol 5e-5 + rtol 1e-5; bfloat16: at most twice the
    plain bf16 backward's own error, plus 1e-3)."""
    scale = q.shape[3] ** -0.5
    qf, kf, vf, df = (x.float() for x in (q, k, v, dout))
    out, lse = attention._plain_forward(qf, kf, vf, causal, scale, window)
    delta = (df * out).sum(-1)
    kw = dict(causal=causal, sm_scale=scale, window=window)
    attention.reset_launch_counts()
    dq = attention.flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
    dk, dv = attention.flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
    assert attention.launch_counts["flash_bwd_dq"] == 1
    assert attention.launch_counts["flash_bwd_dkv"] == 1
    ref = attention._plain_backward(qf, kf, vf, df, lse, delta, causal,
                                    scale, window)
    plain = attention._plain_backward(q, k, v, dout, lse, delta, causal,
                                      scale, window)
    for got, want, low in zip((dq, dk, dv), ref, plain):
        assert got.dtype == q.dtype
        if q.dtype == torch.float32:
            torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-5)
        else:
            plain_err = (low.float() - want).abs().max().item()
            assert (got.float() - want).abs().max().item() \
                <= 2.0 * plain_err + 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,window", [
    ((1, 2, 1424, 128), 201),    # the training replay
    ((2, 3, 130, 64), None),     # plain causal, ragged tiles
    ((1, 1, 23, 64), 12),        # shorter than one tile
    ((1, 2, 300, 128), 1),       # each row sees only itself
    ((1, 1, 37, 64), None),      # shorter than one tile, plain causal
    ((2, 2, 130, 128), 1),       # window 1 with ragged tiles
    ((1, 2, 401, 64), 201),      # the serving band at D = 64
    ((40, 2, 130, 128), None),   # B*H = 80 > 64
])
def test_backward_kernels_match_plain(cuda, dtype, shape, window):
    q, k, v, dout = _bwd_inputs(shape, dtype, shape[2])
    _check_backward(q, k, v, dout, causal=True, window=window)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("head_dim", [32, 96])
def test_narrow_heads_pad_to_the_built_width(cuda, dtype, head_dim):
    """head_dim 32 and 96 run through the kernels built for 64 and 128,
    zero-padded and sliced back: forward, dq and dkv against the plain
    versions at the unpadded width, one launch each."""
    shape = (2, 2, 130, head_dim)
    q, k, v = _qkv(shape, dtype, seed=head_dim)
    _check(q, k, v, causal=True, window=33)
    q, k, v, dout = _bwd_inputs(shape, dtype, head_dim)
    _check_backward(q, k, v, dout, causal=True, window=33)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_noncausal_cross_attention(cuda, dtype):
    rng = np.random.default_rng(9)
    q, dout = (torch.from_numpy(rng.standard_normal(
        (2, 2, 100, 64), dtype=np.float32)).to("cuda", dtype)
        for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(
        (2, 2, 257, 64), dtype=np.float32)).to("cuda", dtype)
        for _ in range(2))
    _check_backward(q, k, v, dout, causal=False, window=None)


@pytest.mark.parametrize("shape,kv_len,causal,window,cluster", [
    # 40*2 heads x 3 query tiles = 240 clusters: only c = 1 keeps the grid
    # resident at once.
    ((40, 2, 130, 128), None, True, None, 1),
    # A short causal grid: the widest band holds 3 key tiles, so c = 2.
    ((1, 1, 130, 64), None, True, None, 2),
    # The training replay: 2 x 23 query tiles, bands of up to 5 key tiles.
    ((1, 2, 1424, 128), None, True, 201, 2),
    # Plain causal over 8 query tiles: the widest band holds 8 key tiles.
    ((1, 2, 512, 128), None, True, None, 2),
    # Non-causal 100 x 600: every query tile sees 10 key tiles.
    ((2, 2, 100, 64), 600, False, None, 2),
])
def test_dq_cluster_split_matches_plain(cuda, shape, kv_len, causal, window,
                                        cluster):
    """flash_bwd_dq in bf16 at grids that select each cluster size."""
    rng = np.random.default_rng(shape[2] + cluster)
    kv_shape = shape[:2] + (kv_len or shape[2], shape[3])
    q, dout = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to("cuda", torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal(kv_shape, dtype=np.float32))
            .to("cuda", torch.bfloat16) for _ in range(2))
    assert attention.flash_bwd_dq_cluster(q, k, causal=causal,
                                          window=window) == cluster
    _check_backward(q, k, v, dout, causal=causal, window=window)


@pytest.mark.parametrize("shape,window", [
    ((1, 2, 1424, 128), 201),    # the training replay (c = 2)
    ((1, 2, 512, 128), None),    # plain causal, 8 key tiles (c = 2)
])
def test_dq_repeats_bit_for_bit(cuda, shape, window):
    """A cluster adds its ranks' partial dQs in a fixed order: two calls on
    the same bf16 inputs give the same bits."""
    q, k, v, dout = _bwd_inputs(shape, torch.bfloat16, 7)
    scale = shape[3] ** -0.5
    out, lse = attention._plain_forward(q.float(), k.float(), v.float(),
                                        True, scale, window)
    delta = (dout.float() * out).sum(-1)
    kw = dict(causal=True, sm_scale=scale, window=window)
    first = attention.flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
    second = attention.flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
    assert torch.equal(first, second)


@pytest.mark.parametrize("optimizer,grad_dtype,emit", [
    ("adagrad", torch.bfloat16, True),
    ("adam", torch.float32, False),
    ("sgd", torch.float32, True),
])
def test_fused_update_matches_plain(cuda, optimizer, grad_dtype, emit):
    """Leaves of odd sizes (a scalar, 3, 1000, 130 x 257) and more leaves
    than one launch takes (70 > 64: two launches)."""
    from sharetrade_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(1)
    shapes = [(), (3,), (1000,), (130, 257)] + [(5, 7)] * 66
    params = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    grads = [torch.randn(s, generator=gen, device="cuda").to(grad_dtype)
             for s in shapes]
    n_state = {"adagrad": 1, "adam": 2, "sgd": 0}[optimizer]
    state = [[torch.rand(s, generator=gen, device="cuda") + 0.1
              for s in shapes] for _ in range(n_state)]
    _, bias = fu.adam_bias(torch.tensor(2, dtype=torch.int32, device="cuda"))
    bias = bias if optimizer == "adam" else None
    got_p = [p.clone() for p in params]
    got_s = [[x.clone() for x in s] for s in state]
    compute = ([torch.empty_like(p, dtype=torch.bfloat16) for p in params]
               if emit else None)
    fu.reset_launch_counts()
    fu.fused_update(optimizer, 0.01, got_p, grads, got_s, bias=bias,
                    compute=compute)
    assert fu.launch_counts["fused_update"] == 2
    for i, p in enumerate(params):
        want_p, want_s = fu._plain_leaf(optimizer, 0.01, p, grads[i],
                                        [s[i] for s in state], bias)
        torch.testing.assert_close(got_p[i], want_p, atol=1e-6, rtol=1e-6)
        for j in range(n_state):
            torch.testing.assert_close(got_s[j][i], want_s[j], atol=1e-6,
                                       rtol=1e-6)
        if compute is not None:
            assert torch.equal(compute[i], got_p[i].to(torch.bfloat16))


@pytest.mark.parametrize("optimizer,emit", [("adam", True), ("adagrad", False),
                                            ("sgd", True)])
def test_fused_update_gate_matches_plain(cuda, optimizer, emit):
    """The gate on the card against the plain version's: off, params,
    moments and adam's count stay as they were bit for bit (the compute
    copy the recast of the unchanged masters); on, the result is the
    ungated update's, bit for bit. The reference Q-network's leaf shapes
    (203 x 200, 200, 200 x 3, 3)."""
    from sharetrade_tpu_torch.models.core import tree_leaves
    from sharetrade_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(203, 200), (200,), (200, 3), (3,)]
    params = {f"l{i}": torch.randn(s, generator=gen, device="cuda")
              for i, s in enumerate(shapes)}
    grads = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    outs = {}
    for label, flag in (("off", False), ("on", True), ("none", None)):
        p = {k: v.clone() for k, v in params.items()}
        state = fu.init_state(optimizer, p)
        gate = None if flag is None else torch.tensor(flag, device="cuda")
        out = fu.fused_apply(optimizer, 0.01, grads, state, p,
                             emit_compute=emit, gate=gate)
        outs[label] = (p, state, out[2] if emit else None)
    p_off, s_off, c_off = outs["off"]
    for k in params:
        assert torch.equal(p_off[k], params[k])
        if emit:
            assert torch.equal(c_off[k], params[k].to(torch.bfloat16))
    fresh = fu.init_state(optimizer, params)
    for a, b in zip(tree_leaves(s_off[0]), tree_leaves(fresh[0])):
        assert torch.equal(a, b)
    p_on, s_on, c_on = outs["on"]
    p_ref, s_ref, c_ref = outs["none"]
    for k in params:
        assert torch.equal(p_on[k], p_ref[k])
        if emit:
            assert torch.equal(c_on[k], c_ref[k])
    if optimizer == "adam":
        assert int(s_off[0].count) == 0 and int(s_on[0].count) == 1


def test_fused_update_refuses_what_the_kernel_does_not_take(cuda):
    from sharetrade_tpu_torch.ops import fused_update as fu

    p = [torch.zeros(8, device="cuda")]
    with pytest.raises(ValueError, match="float16"):
        fu.fused_update("sgd", 0.1, p, [torch.zeros(8, device="cuda").half()],
                        [])
    with pytest.raises(ValueError, match="shape"):
        fu.fused_update("sgd", 0.1, p, [torch.zeros(9, device="cuda")], [])
    with pytest.raises(ValueError, match="state"):
        fu.fused_update("adagrad", 0.1, p, [torch.zeros(8, device="cuda")],
                        [])
    with pytest.raises(ValueError, match="bias"):
        fu.fused_update("adam", 0.1, p, [torch.zeros(8, device="cuda")],
                        [p, p])
    with pytest.raises(ValueError, match="compute"):
        fu.fused_update("sgd", 0.1, p, [torch.zeros(8, device="cuda")], [],
                        compute=[torch.zeros(8, device="cuda")])
    with pytest.raises(ValueError, match="gate"):
        fu.fused_update("sgd", 0.1, p, [torch.zeros(8, device="cuda")], [],
                        gate=torch.ones(2, device="cuda"))


def _update_against_plain(fu, optimizer, params, grads, *, gen, emit,
                          gate=None):
    """One fused_update of copies of ``params`` against the plain per-leaf
    math; the compute copy must be the exact recast, and with the gate off
    masters and moments must keep their bits."""
    n_state = {"adagrad": 1, "adam": 2, "sgd": 0}[optimizer]
    state = [[torch.rand(p.shape, generator=gen, device="cuda") + 0.1
              for p in params] for _ in range(n_state)]
    _, bias = fu.adam_bias(torch.tensor(2, dtype=torch.int32, device="cuda"))
    bias = bias if optimizer == "adam" else None
    got_p = [p.clone() for p in params]
    got_s = [[x.clone() for x in s] for s in state]
    compute = ([torch.empty_like(p, dtype=torch.bfloat16) for p in params]
               if emit else None)
    fu.fused_update(optimizer, 0.01, got_p, grads, got_s, bias=bias,
                    compute=compute, gate=gate)
    flag = None if gate is None else gate.reshape(()).bool()
    for i, p in enumerate(params):
        want_p, want_s = fu._plain_leaf(optimizer, 0.01, p, grads[i],
                                        [s[i] for s in state], bias, flag)
        torch.testing.assert_close(got_p[i], want_p, atol=1e-6, rtol=1e-6)
        for j in range(n_state):
            torch.testing.assert_close(got_s[j][i], want_s[j], atol=1e-6,
                                       rtol=1e-6)
        if compute is not None:
            assert torch.equal(compute[i], got_p[i].to(torch.bfloat16))
        if flag is not None and not bool(flag):
            assert torch.equal(got_p[i], p)
            for j in range(n_state):
                assert torch.equal(got_s[j][i], state[j][i])
    return got_p, got_s, compute


@pytest.mark.parametrize("optimizer,grad_dtype,emit", [
    ("adagrad", torch.bfloat16, True),
    ("adagrad", torch.float32, False),
    ("adam", torch.float32, True),
    ("sgd", torch.bfloat16, False),
])
def test_fused_update_odd_sizes_and_misaligned_leaves(cuda, optimizer,
                                                      grad_dtype, emit):
    """Leaves of 0, 1, 3, 7, 8, 9, 1,023 and 1,025 elements (a scalar
    tail after the 16-byte units, or nothing but one), and leaves that are
    contiguous views at element offset 1 of a larger buffer (a master, a
    grad, both): those take the scalar path whole."""
    from sharetrade_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(3)
    sizes = [0, 1, 3, 7, 8, 9, 1023, 1025]

    def randn(n, dtype=torch.float32):
        return torch.randn(n, generator=gen, device="cuda").to(dtype)

    params = [randn(n) for n in sizes] + [randn(1026)[1:], randn(1026),
                                          randn(9)[1:]]
    grads = [randn(n, grad_dtype) for n in sizes] + [
        randn(1025, grad_dtype), randn(1027, grad_dtype)[1:],
        randn(9, grad_dtype)[1:]]
    assert params[-3].data_ptr() % 16 and grads[-2].data_ptr() % 16
    _update_against_plain(fu, optimizer, params, grads, gen=gen, emit=emit)


@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8, torch.int32,
                                   torch.int64])
def test_fused_update_reads_the_gate_in_its_own_dtype(cuda, dtype):
    """The gate is read in its own width, with no cast launched: off leaves
    masters and moments bit for bit (the compute copy the recast of the
    old masters), on gives the ungated update bit for bit."""
    from sharetrade_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(4)
    shapes = [(203, 200), (200,), (200, 3), (3,)]
    params = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    grads = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    for value in (0, 1):
        gate = torch.tensor(value, device="cuda").to(dtype)
        g2 = torch.Generator(device="cuda").manual_seed(5)
        _, _, compute = _update_against_plain(
            fu, "adagrad", params, grads, gen=g2, emit=True, gate=gate)
        if value == 0:
            for c, p in zip(compute, params):
                assert torch.equal(c, p.to(torch.bfloat16))


@pytest.mark.parametrize("optimizer,emit,gated", [
    ("adam", True, True), ("adagrad", False, True), ("sgd", True, False)])
def test_fused_apply_captured_in_a_cuda_graph_replays_bit_equal(
        cuda, optimizer, emit, gated):
    """``fused_apply``, gate included, captured once in a CUDA graph and
    replayed over the same static buffers gives masters, moments, adam's
    count and the compute copy bit-equal to the same eager calls; the gate
    is flipped between replays (on, off, on), so the replay reads it on
    the device."""
    from sharetrade_tpu_torch.models.core import tree_leaves
    from sharetrade_tpu_torch.ops import fused_update as fu

    gen = torch.Generator(device="cuda").manual_seed(6)
    shapes = [(203, 200), (200,), (200, 3), (3,), (1025,)]
    init = {f"l{i}": torch.randn(s, generator=gen, device="cuda")
            for i, s in enumerate(shapes)}
    grads = [torch.randn(s, generator=gen, device="cuda") for s in shapes]
    flags = [True, False, True]

    def fresh():
        p = {k: v.clone() for k, v in init.items()}
        return p, fu.init_state(optimizer, p)

    gate = torch.tensor(True, device="cuda") if gated else None

    def step(p, state):
        return fu.fused_apply(optimizer, 0.01, grads, state, p,
                              emit_compute=emit, gate=gate)

    eager_p, eager_s = fresh()
    for flag in flags:
        if gated:
            gate.fill_(flag)
        out = step(eager_p, eager_s)
    eager_c = out[2] if emit else None

    graph_p, graph_s = fresh()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step(graph_p, graph_s)
    torch.cuda.current_stream().wait_stream(side)
    reset_p, reset_s = fresh()
    for a, b in zip(tree_leaves((graph_p, graph_s)),
                    tree_leaves((reset_p, reset_s))):
        a.copy_(b)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(graph_p, graph_s)
    for flag in flags:
        if gated:
            gate.fill_(flag)
        graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(tree_leaves((graph_p, graph_s)),
                    tree_leaves((eager_p, eager_s))):
        assert torch.equal(a, b)
    if emit:
        for a, b in zip(tree_leaves(out[2]), tree_leaves(eager_c)):
            assert torch.equal(a, b)


def test_ppo_minibatch_through_kernels_matches_plain(cuda):
    """One PPO minibatch at a reduced flagship (Dh 128, window 201; 16
    agents, unroll 32, bf16_mixed) three ways: the bf16 model through the
    kernels, the bf16 model through the plain attention, and the fp32 model
    through the plain attention, the reference."""
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.agents.rollout import (
        collect_rollout, gae_advantages, normalize_advantages_masked,
        replay_forward)
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import make_trading_env
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.precision import PrecisionPolicy

    overrides = [
        "learner.algo=ppo", "model.kind=transformer", "model.seq_mode=episode",
        "model.num_heads=2", "model.head_dim=128", "env.window=201",
        "parallel.num_workers=16", "runtime.chunk_steps=32"]
    cfg = FrameworkConfig().apply_overrides(
        overrides + ["precision.mode=bf16_mixed"])
    cfg32 = FrameworkConfig().apply_overrides(overrides)
    rng = np.random.default_rng(0)
    prices = (50 * np.exp(np.cumsum(rng.uniform(-0.02, 0.02, 400)))).astype(
        np.float32)
    env = make_trading_env(prices, window=201, device=cuda)

    def plain(c):
        return build_agent(c, env, build_model(
            c.model, env.obs_dim, device=cuda,
            attention_fn=lambda q, k, v, w: attention.reference_attention(
                q, k, v, causal=True, sm_scale=128 ** -0.5,
                local_window=w)), device=cuda)

    agent = build_agent(cfg, env, device=cuda)
    ts = agent.init(0)
    compute = PrecisionPolicy(mode="bf16_mixed").cast_compute(ts.params)
    _, traj, boot, carry = collect_rollout(agent.model, env, ts, 32, 16,
                                           params=compute)
    adv = gae_advantages(traj.reward, traj.value, traj.active, boot, 0.001,
                         0.95)
    idx = torch.arange(4, device=cuda)
    ret = (adv + traj.value).index_select(1, idx)
    adv, traj = adv.index_select(1, idx), traj.take(idx)
    carry = {k: v.index_select(0, idx) for k, v in carry.items()}
    carry32 = {k: v.float() if v.is_floating_point() else v
               for k, v in carry.items()}
    paths = {"kernel": (agent, compute, carry),
             "plain": (plain(cfg), compute, carry),
             "fp32": (plain(cfg32), ts.params, carry32)}
    got = {}
    for name, (ag, params, c) in paths.items():
        with torch.no_grad():
            logits, values, _ = replay_forward(ag.model, params, traj, c)
        attention.reset_launch_counts()
        terms, grads = ag.minibatch_grads(params, traj, c, adv, ret)
        if name == "kernel":
            assert attention.launch_counts["flash_bwd_dq"] == 2
        logp = torch.log_softmax(logits.float(), -1).gather(
            -1, traj.action[..., None])[..., 0]
        terms = terms.float()
        got[name] = [logp, values.float(), terms[2], terms[3],
                     *(g.float() for g in grads)], terms[1], logp
    ref = got["fp32"][0]
    for j, (k, p, r) in enumerate(zip(got["kernel"][0], got["plain"][0], ref)):
        size = r.abs().max() if j < 2 else r.norm()
        dist = ((lambda a: (a - r).abs().max()) if j < 2
                else (lambda a: (a - r).norm()))
        assert dist(k) <= 2.0 * dist(p) + 2.0 ** -8 * size, j
    w = traj.active
    denom = torch.clamp(w.sum(), min=1.0)
    d_ratio = (torch.exp(got["kernel"][2] - traj.logp)
               - torch.exp(got["plain"][2] - traj.logp)).abs()
    bound = (normalize_advantages_masked(adv, w, denom).abs() * d_ratio
             * w).sum() / denom + 1e-6
    assert (got["kernel"][1] - got["plain"][1]).abs() <= bound


def _small_cuda_agent(cuda):
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.env.trading import make_trading_env

    cfg = FrameworkConfig().apply_overrides([
        "learner.algo=ppo", "model.kind=transformer", "model.seq_mode=episode",
        "model.num_heads=2", "model.head_dim=64", "env.window=33",
        "parallel.num_workers=8", "runtime.chunk_steps=16",
        "precision.mode=bf16_mixed"])
    rng = np.random.default_rng(0)
    prices = (50 * np.exp(np.cumsum(rng.uniform(-0.02, 0.02, 120)))).astype(
        np.float32)
    return build_agent(cfg, make_trading_env(prices, window=33, device=cuda),
                       device=cuda)


def _same_bits(a, b):
    from sharetrade_tpu_torch import convert
    la, lb = convert.train_state_leaves(a), convert.train_state_leaves(b)
    assert set(la) == set(lb)
    for name in la:
        x, y = la[name], lb[name]
        assert x.device == y.device and x.dtype == y.dtype, name
        if x.dtype == torch.bfloat16:
            x, y = x.view(torch.int16), y.view(torch.int16)
        assert torch.equal(x, y), name


def test_checkpoint_round_trips_cuda_generator_bitwise(cuda, tmp_path):
    from sharetrade_tpu_torch.checkpoint import CheckpointManager

    agent = _small_cuda_agent(cuda)
    ts, _ = agent.step(agent.init(0))
    torch.rand(5, generator=ts.rng, device=cuda)     # move the stream on
    mgr = CheckpointManager(str(tmp_path), precision_mode="bf16_mixed")
    mgr.save(int(ts.updates), ts)
    restored, _ = mgr.restore(agent.init(7))
    assert restored.rng.device.type == "cuda"
    assert torch.equal(restored.rng.get_state(), ts.rng.get_state())
    _same_bits(ts, restored)
    assert torch.equal(torch.rand(64, generator=ts.rng, device=cuda),
                       torch.rand(64, generator=restored.rng, device=cuda))


def test_pinned_async_save_then_restore_gives_the_same_bits(cuda, tmp_path):
    from sharetrade_tpu_torch.checkpoint import CheckpointManager
    from sharetrade_tpu_torch.runtime.orchestrator import _clone_state

    agent = _small_cuda_agent(cuda)
    ts, _ = agent.step(agent.init(0))
    want = _clone_state(ts)
    mgr = CheckpointManager(str(tmp_path), precision_mode="bf16_mixed")
    mgr.save_async(int(ts.updates), ts)
    agent.step(ts)          # updates params and moments in place, at once
    assert mgr.wait_pending(timeout=60)
    restored, _ = mgr.restore(agent.init(7))
    _same_bits(want, restored)
    stats = mgr.save_stats[-1]
    assert stats["d2h_ms"] > 0 and stats["writer_ms"] > 0


# ---------------------------------------------------------------------------
# the chunk as a CUDA graph
# ---------------------------------------------------------------------------

_MLP = ["model.kind=mlp", "model.hidden_dim=32", "env.window=16",
        "parallel.num_workers=4", "runtime.chunk_steps=8"]
GRAPH_LEARNERS = {
    "qlearn": ["learner.algo=qlearn"] + _MLP,
    "dqn": ["learner.algo=dqn", "learner.replay_capacity=256",
            "learner.replay_batch=16"] + _MLP,
    "dqn_per": ["learner.algo=dqn", "learner.replay_capacity=256",
                "learner.replay_batch=16",
                "learner.replay_priority=per"] + _MLP,
    "pg": ["learner.algo=pg"] + _MLP,
    "a2c": ["learner.algo=a2c"] + _MLP,
    "ppo": ["learner.algo=ppo", "model.kind=transformer",
            "model.seq_mode=episode", "model.num_heads=2",
            "model.head_dim=64", "env.window=33", "parallel.num_workers=8",
            "runtime.chunk_steps=16", "precision.mode=bf16_mixed"],
}
#: The other policy families (window transformer dense / MoE top-0 / top-2,
#: fp32 and bf16, the LSTM under PPO and A2C, the TCN, and the 2-asset
#: portfolio), at the kernels' head dims.
_WINDOW = ["model.kind=transformer", "model.num_heads=2", "env.window=33",
           "parallel.num_workers=4", "runtime.chunk_steps=8"]
GRAPH_LEARNERS.update({
    "ppo_window": ["learner.algo=ppo", "model.head_dim=64"] + _WINDOW,
    "ppo_window_bf16": ["learner.algo=ppo", "model.head_dim=128",
                        "precision.mode=bf16_mixed"] + _WINDOW,
    "ppo_window_moe_top0": ["learner.algo=ppo", "model.head_dim=64",
                            "model.moe_experts=4"] + _WINDOW,
    "ppo_window_moe_top2": ["learner.algo=ppo", "model.head_dim=64",
                            "model.moe_experts=4", "model.moe_top_k=2",
                            "model.moe_capacity_factor=0.5"] + _WINDOW,
    "ppo_lstm": ["learner.algo=ppo", "model.kind=lstm",
                 "model.hidden_dim=32", "env.window=33",
                 "parallel.num_workers=4", "runtime.chunk_steps=8"],
    "a2c_lstm": ["learner.algo=a2c", "model.kind=lstm",
                 "model.hidden_dim=32", "env.window=33",
                 "parallel.num_workers=4", "runtime.chunk_steps=8"],
    "ppo_tcn": ["learner.algo=ppo", "model.kind=tcn", "model.hidden_dim=32",
                "env.window=33", "parallel.num_workers=4",
                "runtime.chunk_steps=8"],
    "ppo_portfolio": ["learner.algo=ppo", "model.head_dim=64"] + _WINDOW,
})


#: DQN with its transitions collected (``learner.journal_replay``).
JOURNAL_LEARNERS = {
    f"{name}_journal": GRAPH_LEARNERS[name] + ["learner.journal_replay=true"]
    for name in ("dqn", "dqn_per")}


def _graph_and_eager(learner, cuda, tmp_path):
    """Two orchestrators of the same small run: one whose chunks go
    through its chunk program, one whose program is taken away (its state
    plain tensors, its chunks ``agent.step``)."""
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.runtime import Orchestrator

    rng = np.random.default_rng(0)
    # The portfolio learner trades two series (an (A, T) price matrix).
    shape = (2, 200) if learner == "ppo_portfolio" else (200,)
    prices = (50 * np.exp(np.cumsum(rng.uniform(-0.02, 0.02, shape),
                                    axis=-1))).astype(np.float32)
    pair = []
    for name in ("graph", "eager"):
        cfg = FrameworkConfig().apply_overrides(
            {**GRAPH_LEARNERS, **JOURNAL_LEARNERS}[learner]
            + [f"runtime.checkpoint_dir={tmp_path / name}",
               f"data.journal_dir={tmp_path / (name + '-journal')}"])
        orch = Orchestrator(cfg, device=cuda)
        orch.send_training_data(prices)
        pair.append(orch)
    pair[1]._program = None
    return pair


@pytest.mark.parametrize("learner", sorted(GRAPH_LEARNERS))
def test_graph_chunks_are_bitwise_the_eager_chunks(cuda, learner, tmp_path):
    """Four chunks of each learner through the chunk program (chunk 1
    eager, chunk 2 captured and replayed, chunks 3-4 replayed), a re-arm
    after chunk 2 and a poisoned row healed after chunk 3, both loaded
    into the graph's buffers: the state (every leaf and the generator),
    every chunk's metrics and each kernel's launch count equal four eager
    ``agent.step`` chunks with the same re-arm and heal, bit for bit."""
    from sharetrade_tpu_torch.agents.base import _metric_vector
    from sharetrade_tpu_torch.ops import fused_update as fu

    graph, eager = _graph_and_eager(learner, cuda, tmp_path)
    program = graph._program
    runs = {}
    for name, orch in (("graph", graph), ("eager", eager)):
        attention.reset_launch_counts()
        fu.reset_launch_counts()
        rows = []
        for c in range(4):
            if name == "graph":
                orch._ts, stacked = program(orch._ts)
                rows.append(stacked.values[0].clone())
            else:
                orch._ts, metrics = orch.agent.step(orch._ts)
                rows.append(_metric_vector(metrics, tuple(metrics), cuda))
            if c == 1:
                orch.episode += 1
                orch._reset_episode()
            if c == 2:
                env = orch._ts.env_state
                budget = env.budget.clone()
                budget[1] = float("nan")
                orch._ts = orch._ts.replace(env_state=env.replace(
                    budget=budget))
                assert orch._heal_agents()
        torch.cuda.synchronize()
        runs[name] = rows, {**attention.launch_counts, **fu.launch_counts}
    assert program.replays == 3 and program.capture_seconds > 0
    _same_bits(graph.train_state, eager.train_state)
    for a, b in zip(runs["graph"][0], runs["eager"][0]):
        assert torch.equal(a, b)
    assert runs["graph"][1] == runs["eager"][1]
    assert sum(runs["graph"][1].values()) > 0


@pytest.mark.parametrize("learner", sorted(JOURNAL_LEARNERS))
def test_graph_transitions_are_bitwise_the_eager_transitions(cuda, learner,
                                                             tmp_path):
    """DQN collecting its transitions: four chunks through the chunk
    program with a re-arm after chunk 2 and a heal after chunk 3, as in
    the test above; every chunk's transitions (obs, action, reward,
    next_obs, valid: the captured step's static buffers, copied into the
    dispatch's slot and read back) equal the eager chunks' bit for bit, as
    do the states; after the heal every row is valid again."""
    from sharetrade_tpu_torch.agents.base import _split_transitions

    graph, eager = _graph_and_eager(learner, cuda, tmp_path)
    program = graph._program
    runs = {}
    for name, orch in (("graph", graph), ("eager", eager)):
        chunks = []
        for c in range(4):
            if name == "graph":
                orch._ts, stacked = program(orch._ts)
                got = program.readback(stacked).transitions()
                chunks.append({k: torch.from_numpy(v[0].copy())
                               for k, v in got.items()})
            else:
                orch._ts, metrics = orch.agent.step(orch._ts)
                _, tr = _split_transitions(metrics)
                chunks.append({k: v.cpu() for k, v in tr.items()})
            if c == 1:
                orch.episode += 1
                orch._reset_episode()
            if c == 2:
                env = orch._ts.env_state
                budget = env.budget.clone()
                budget[1] = float("nan")
                orch._ts = orch._ts.replace(env_state=env.replace(
                    budget=budget))
                assert orch._heal_agents()
        runs[name] = chunks
    assert program.replays == 3
    _same_bits(graph.train_state, eager.train_state)
    for a, b in zip(runs["graph"], runs["eager"]):
        assert sorted(a) == ["action", "next_obs", "obs", "reward", "valid"]
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
    assert bool(runs["graph"][3]["valid"].all())
    graph.stop()
    eager.stop()


def test_a_dead_graph_collected_during_the_capture_does_not_break_it(
        cuda, tmp_path):
    """A CUDA graph dead in a reference cycle (as an earlier run's chunk
    program is, held by an exception's traceback) whose cycle becomes
    garbage while the next chunk is captured: with the collector at its
    most eager, a collection there would run the graph's destructor on the
    capturing thread and invalidate the capture. The chunk program pauses
    the collector for the capture, so the capture and its replays hold,
    and the graph is collected after it."""
    import dataclasses
    import gc
    import weakref

    graph_run, _ = _graph_and_eager("qlearn", cuda, tmp_path)
    x = torch.zeros(1024, device=cuda)
    dead = torch.cuda.CUDAGraph()
    with torch.cuda.graph(dead):
        x.add_(1)
    dead.replay()
    torch.cuda.synchronize()
    gone = weakref.ref(dead)
    stock = [dead]
    del dead
    step = graph_run.agent.step
    capturing = []

    def step_dropping_a_graph(ts, draws=None):
        if torch.cuda.is_current_stream_capturing() and stock:
            cycle = [stock.pop()]
            cycle.append(cycle)
            del cycle
            capturing.append([[] for _ in range(64)])   # allocations: gen 0
        return step(ts, draws=draws)

    program = graph_run._program
    program.agent = dataclasses.replace(graph_run.agent,
                                        step=step_dropping_a_graph)
    ts, _ = program(graph_run._ts)              # the eager warm-up chunk
    threshold = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        ts, _ = program(ts)                     # captured, then replayed
        ts, _ = program(ts)
        torch.cuda.synchronize()
    finally:
        gc.set_threshold(*threshold)
    assert capturing and program.replays == 2
    gc.collect()
    assert gone() is None
    graph_run.stop()


def test_a_chunk_that_cannot_be_captured_raises(cuda, tmp_path):
    """A step that reads a value back to the host cannot be captured: the
    chunk program raises on the dispatch that captures and never steps
    eagerly instead."""
    import dataclasses

    graph, _ = _graph_and_eager("qlearn", cuda, tmp_path)
    step = graph.agent.step

    def host_sync_step(ts, draws=None):
        ts, metrics = step(ts, draws=draws)
        float(metrics["loss"])
        return ts, metrics

    program = graph._program
    program.agent = dataclasses.replace(graph.agent, step=host_sync_step)
    ts, _ = program(graph._ts)              # the eager warm-up chunk
    updates = int(ts.updates)
    with pytest.raises(RuntimeError):
        program(ts)
    assert program.replays == 0 and program.capture_seconds is None
    assert int(ts.updates) == updates


# ---------------------------------------------------------------------------
# serving's live knobs and online controller on the card (the flagship)
# ---------------------------------------------------------------------------

FLAGSHIP_SERVE = [
    "learner.algo=ppo", "model.kind=transformer", "model.seq_mode=episode",
    "model.num_layers=2", "model.num_heads=2", "model.head_dim=128",
    "env.window=201", "precision.mode=bf16_mixed", "serve.max_batch=64",
    "serve.slots=256", "serve.stats_interval_s=0.25"]


def _flagship_engine(cuda, **serve):
    import dataclasses

    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.data.synthetic import synthetic_price_series
    from sharetrade_tpu_torch.env.trading import obs_dim
    from sharetrade_tpu_torch.models import build_model
    from sharetrade_tpu_torch.precision import policy_from_config
    from sharetrade_tpu_torch.serve import ServeEngine

    cfg = FrameworkConfig().apply_overrides(FLAGSHIP_SERVE)
    model = build_model(cfg.model, obs_dim(cfg.env.window), device=cuda)
    engine = ServeEngine(
        model, dataclasses.replace(cfg.serve, **serve),
        model.init(torch.Generator().manual_seed(cfg.seed)),
        precision=policy_from_config(cfg.precision))
    engine.warmup()
    return engine, synthetic_price_series(length=2048).prices, cfg


def test_flagship_engine_takes_live_knobs_mid_load(cuda):
    """Closed loop over 192 sessions; halfway, a tighter knob vector: every
    answer finite, the ingress bound and gauges retargeted, the stages
    telescoping, flash_fwd launched on the cold ticks."""
    import threading

    from sharetrade_tpu_torch.serve.driver import make_sessions, run_closed_loop

    engine, prices, cfg = _flagship_engine(cuda)
    attention.reset_launch_counts()
    out: dict = {}
    try:
        thread = threading.Thread(target=lambda: out.update(run_closed_loop(
            engine, make_sessions(prices, cfg.env.window, 192, seed=1),
            concurrency=192, duration_s=2.0)))
        thread.start()
        thread.join(1.0)
        knobs = engine.set_knobs(batch_timeout_ms=0.5, max_queue=128)
        assert tuple(knobs) == (0.5, 128) and engine._q.maxsize == 128
        thread.join(120.0)
        assert engine.drain(60.0)
        reg = engine.registry
        assert out["completed"] > 0
        assert reg.latest("serve_knob_max_queue") == 128.0
        assert reg.counters().get(
            "serve_trace_decomposition_error_total", 0) == 0
        assert engine.latency_histogram.count == engine.counters["completed"]
        assert reg.latest("serve_p99_ms") > 0
        assert attention.launch_counts["flash_fwd"] == (
            cfg.model.num_layers * engine.counters["cold_batches"]) > 0
    finally:
        engine.stop(timeout_s=30.0)


def test_controller_tightens_then_relaxes_on_the_card(cuda):
    """An unmeetable target tightens both knobs under 128 sessions in
    flight; a second controller with a generous target grows them back
    under 32 (fewer than the tightened queue holds, so no window is
    overloaded), never past config."""
    from sharetrade_tpu_torch.serve import ServeController
    from sharetrade_tpu_torch.serve.driver import make_sessions, run_closed_loop

    engine, prices, cfg = _flagship_engine(cuda, max_queue=512)
    ceiling = (engine.cfg.batch_timeout_ms, engine.cfg.max_queue)
    try:
        for target, sessions, prefix in ((0.01, 128, "t"), (1e4, 32, "r")):
            ctl = ServeController(engine, target_p99_ms=target,
                                  interval_s=0.2).start()
            start = tuple(engine.knobs)
            run_closed_loop(engine, make_sessions(
                prices, cfg.env.window, sessions, seed=2, prefix=prefix),
                concurrency=sessions, duration_s=1.5)
            ctl.stop()
            end = tuple(engine.knobs)
            assert ctl.adjustments > 0
            assert end[0] <= ceiling[0] and end[1] <= ceiling[1]
            if target < 1:
                assert end[0] < start[0] and end[1] < start[1]
            else:
                assert end[1] > start[1]
    finally:
        engine.stop(timeout_s=30.0)
