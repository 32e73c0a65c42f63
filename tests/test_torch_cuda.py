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
bf16 compute copy exact; one PPO minibatch as ``chip_smoke.py`` holds the
flagship's (``MB_FACTOR`` there): against the fp32 model, the kernel path's
error at most twice the plain bf16 path's plus 2^-8 of the reference's
size, and the policy term within the bound its formula gives.
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
        x = torch.zeros((1, 1, 16, 32), device="cuda")
        attention.flash_fwd(x, x, x, sm_scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        attention.flash_fwd(q.transpose(2, 3), k.transpose(2, 3),
                            v.transpose(2, 3), sm_scale=1.0)
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
