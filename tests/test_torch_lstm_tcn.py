"""The port's LSTM and TCN against the JAX package's, on the CPU.

Same converted weights (JAX init, ``convert.params_from_jax``), same
numpy-seeded observations (price windows from a walk with 1-3% log-returns,
budgets, share counts). Size: window 16, LSTM hidden 16, TCN 16 channels
(4 blocks: dilations 1, 2, 4, 8, ``default_num_blocks(16)``).

- LSTM: one batched step (the JAX model's per-session ``apply`` vmapped)
  from a nonzero carry: logits, values and the new ``(h, c)``; the scanned
  replay (``agents/rollout.replay_forward`` over 6 steps x 4 agents from a
  nonzero initial carry) and its gradient.
- TCN: the causal dilated convolution alone at each dilation against
  ``jax.lax.conv_general_dilated``; the receptive-field sizing over
  windows 1..400; the forward and its gradient.

Tolerances: float32, outputs and carries within 1e-5 absolute + 1e-5
relative, gradients within 1e-4 absolute + 1e-4 relative (the same
products summed in another order). bf16 compute copy (params and carry
cast as ``precision.mode=bf16_mixed`` casts them): logits within 5e-3 and
values within 5e-2 absolute, the carry within 5e-2 absolute (entries of
order 1, bf16 ulp 2^-7 relative, a few roundings apart), as
tests/test_torch_episode_model.py holds its bf16 model; gradients by the
rule of tests/test_torch_window_transformer.py (against the JAX float32
gradients: the port's mean relative L2 error over the leaves at most twice
JAX's bf16 mean plus 2^-8, each leaf's at most twice JAX's plus 2^-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.agents import rollout as jrollout
from sharetrade_tpu.models import lstm as jlstm
from sharetrade_tpu.models import tcn as jtcn
from sharetrade_tpu.precision import PrecisionPolicy as JaxPolicy
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import rollout as trollout
from sharetrade_tpu_torch.models import lstm as tlstm
from sharetrade_tpu_torch.models import tcn as ttcn
from sharetrade_tpu_torch.precision import PrecisionPolicy as TorchPolicy

WINDOW, HIDDEN, ROWS = 16, 16, 5
OBS = WINDOW + 2
MODES = ["fp32", "bf16_mixed"]


def _obs(rng, rows):
    steps = rng.uniform(0.01, 0.03, (rows, WINDOW)) * rng.choice(
        [-1.0, 1.0], (rows, WINDOW))
    windows = 50.0 * np.exp(np.cumsum(steps, axis=-1))
    return np.concatenate([windows, rng.uniform(0.0, 3000.0, (rows, 1)),
                           rng.integers(0, 6, (rows, 1))],
                          axis=1).astype(np.float32)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _t(x, dtype=None):
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t if dtype is None else t.to(dtype)


def _check_out(mode, got, want, atol_f32=1e-5, atol_bf16=5e-3):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if mode == "fp32":
        np.testing.assert_allclose(got, want, atol=atol_f32, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=atol_bf16, rtol=0)


def _check_grads(mode, tg, jg, ref_g):
    assert sorted(tg) == sorted(jg)
    if mode == "fp32":
        for k in jg:
            np.testing.assert_allclose(tg[k], jg[k], atol=1e-4, rtol=1e-4,
                                       err_msg=k)
        return
    port_e = {k: _rel_l2(tg[k], ref_g[k]) for k in jg}
    jax_e = {k: _rel_l2(jg[k], ref_g[k]) for k in jg}
    for k in jg:
        assert port_e[k] <= 2 * jax_e[k] + 2 ** -4, (k, port_e[k], jax_e[k])
    assert np.mean(list(port_e.values())) <= \
        2 * np.mean(list(jax_e.values())) + 2 ** -8


def _torch_grads(params, loss_fn):
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in convert.flatten(params, leaf=lambda x: x).items()}
    loss_fn(convert.unflatten(leaves)).backward()
    return {k: v.grad.float().numpy() for k, v in leaves.items()}


def _jax_grads(loss_fn, params):
    g = jax.jit(jax.grad(loss_fn))(params)
    return convert.flatten(jax.tree.map(lambda a: np.asarray(a, np.float32),
                                        g))


# ---------------------------------------------------------------------------
# LSTM
# ---------------------------------------------------------------------------

def _lstm(mode):
    jm = jlstm.lstm_policy(OBS, HIDDEN, 3)
    tm = tlstm.lstm_policy(OBS, HIDDEN, 3, device="cpu")
    jp = jm.init(jax.random.PRNGKey(2))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return (jm, tm, JaxPolicy(mode=mode).cast_compute(jp),
            TorchPolicy(mode=mode).cast_compute(tp), jp)


def test_lstm_init_tree_and_carry():
    jm, tm, jp, _, _ = _lstm("fp32")
    assert sorted(convert.flatten(convert.params_to_numpy(
        tm.init(torch.Generator().manual_seed(0))))) == \
        sorted(convert.flatten(jax.tree.map(np.asarray, jp)))
    carry = tm.init_carry()
    assert isinstance(carry, tuple) and len(carry) == 2
    assert all(c.shape == (HIDDEN,) and not c.any() for c in carry)
    bf16 = TorchPolicy(mode="bf16_mixed").cast_carry(carry, tm)
    assert isinstance(bf16, tuple)
    assert all(c.dtype == torch.bfloat16 for c in bf16)


@pytest.mark.parametrize("mode", MODES)
def test_lstm_step_and_carry(mode):
    jm, tm, jp, tp, _ = _lstm(mode)
    rng = np.random.default_rng(4)
    obs = _obs(rng, ROWS)
    h0, c0 = (rng.standard_normal((ROWS, HIDDEN)).astype(np.float32) * 0.5
              for _ in range(2))
    dtype = jnp.bfloat16 if mode != "fp32" else jnp.float32
    jout, (jh, jc) = jax.vmap(lambda o, h, c: jm.apply(jp, o, (h, c)))(
        obs, jnp.asarray(h0, dtype), jnp.asarray(c0, dtype))
    tdtype = torch.bfloat16 if mode != "fp32" else torch.float32
    tout, (th, tc) = tm.apply_batch(tp, _t(obs), (_t(h0, tdtype),
                                                  _t(c0, tdtype)))
    assert th.dtype == tc.dtype == tdtype
    _check_out(mode, tout.logits, jout.logits)
    _check_out(mode, tout.value, jout.value, atol_bf16=5e-2)
    for got, want in ((th, jh), (tc, jc)):
        _check_out(mode, got, want, atol_bf16=5e-2)


@pytest.mark.parametrize("mode", MODES)
def test_lstm_scanned_replay_and_grads(mode):
    jm, tm, jp, tp, masters = _lstm(mode)
    steps, agents = 6, 4
    rng = np.random.default_rng(6)
    obs = _obs(rng, steps * agents).reshape(steps, agents, OBS)
    h0, c0 = (rng.standard_normal((agents, HIDDEN)).astype(np.float32) * 0.5
              for _ in range(2))
    c1 = rng.standard_normal((steps, agents, 3)).astype(np.float32)
    c2 = rng.standard_normal((steps, agents)).astype(np.float32)
    zeros = np.zeros((steps, agents), np.float32)

    def jloss_for(dtype):
        traj = jrollout.StepData(
            obs=jnp.asarray(obs), action=jnp.zeros((steps, agents),
                                                   jnp.int32),
            logp=zeros, value=zeros, reward=zeros, active=zeros)
        carry = (jnp.asarray(h0, dtype), jnp.asarray(c0, dtype))

        def loss(p):
            logits, values, aux = jrollout.replay_forward(jm, p, traj, carry)
            return jnp.sum(logits * c1) + jnp.sum(values * c2) + aux
        return loss

    bf16 = mode != "fp32"
    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    tdtype = torch.bfloat16 if bf16 else torch.float32
    z = torch.zeros((steps, agents))
    ttraj = trollout.StepData(obs=_t(obs), action=z.long(), logp=z, value=z,
                              reward=z, active=z)
    tcarry = (_t(h0, tdtype), _t(c0, tdtype))
    with torch.no_grad():
        logits, values, aux = trollout.replay_forward(tm, tp, ttraj, tcarry)
    jlogits, jvalues, jaux = jrollout.replay_forward(
        jm, jp, jrollout.StepData(obs=jnp.asarray(obs),
                                  action=jnp.zeros((steps, agents),
                                                   jnp.int32),
                                  logp=zeros, value=zeros, reward=zeros,
                                  active=zeros),
        (jnp.asarray(h0, jdtype), jnp.asarray(c0, jdtype)))
    assert logits.shape == (steps, agents, 3) and float(aux) == 0.0
    _check_out(mode, logits, jlogits)
    _check_out(mode, values, jvalues, atol_bf16=5e-2)

    def tloss(p):
        lg, vl, ax = trollout.replay_forward(tm, p, ttraj, tcarry)
        return (lg * _t(c1)).sum() + (vl * _t(c2)).sum() + ax

    tg = _torch_grads(tp, tloss)
    jg = _jax_grads(jloss_for(jdtype), jp)
    ref_g = _jax_grads(jloss_for(jnp.float32), masters) if bf16 else None
    _check_grads(mode, tg, jg, ref_g)


# ---------------------------------------------------------------------------
# TCN
# ---------------------------------------------------------------------------

def test_tcn_receptive_field_sizing():
    for window in range(1, 401):
        blocks = ttcn.default_num_blocks(window)
        assert blocks == jtcn.default_num_blocks(window)
        assert 1 + (ttcn.KERNEL - 1) * (2 ** blocks - 1) >= window
    assert ttcn.default_num_blocks(201) == 7


@pytest.mark.parametrize("dilation", [1, 2, 4, 8, 16])
def test_tcn_causal_conv_at_each_dilation(dilation):
    rng = np.random.default_rng(dilation)
    x = rng.standard_normal((3, WINDOW, 8)).astype(np.float32)
    p = {"w": rng.standard_normal((3, 8, 5)).astype(np.float32),
         "b": rng.standard_normal((5,)).astype(np.float32)}
    want = jtcn._causal_conv(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             dilation)
    got = ttcn._causal_conv({k: _t(v) for k, v in p.items()}, _t(x),
                            dilation)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    # Causal: position t reads nothing after t.
    x2 = x.copy()
    x2[:, 9:] += 1.0
    got2 = ttcn._causal_conv({k: _t(v) for k, v in p.items()}, _t(x2),
                             dilation)
    assert torch.equal(got[:, :9], got2[:, :9])


@pytest.mark.parametrize("mode", MODES)
def test_tcn_forward_and_grads(mode):
    jm = jtcn.tcn_policy(OBS, 3, channels=HIDDEN)
    tm = ttcn.tcn_policy(OBS, 3, channels=HIDDEN, device="cpu")
    masters = jm.init(jax.random.PRNGKey(3))
    assert len(masters["blocks"]) == ttcn.default_num_blocks(WINDOW) == 4
    assert sorted(convert.flatten(convert.params_to_numpy(
        tm.init(torch.Generator().manual_seed(0))))) == \
        sorted(convert.flatten(jax.tree.map(np.asarray, masters)))
    jp = JaxPolicy(mode=mode).cast_compute(masters)
    tp = TorchPolicy(mode=mode).cast_compute(
        convert.params_from_jax(jax.tree.map(np.asarray, masters)))
    rng = np.random.default_rng(7)
    obs = _obs(rng, ROWS)
    c1 = rng.standard_normal((ROWS, 3)).astype(np.float32)
    c2 = rng.standard_normal((ROWS,)).astype(np.float32)
    jout, _ = jm.apply_batch(jp, jnp.asarray(obs), ())
    with torch.no_grad():
        tout, carry = tm.apply_batch(tp, _t(obs), {})
    assert carry == {}
    _check_out(mode, tout.logits, jout.logits)
    _check_out(mode, tout.value, jout.value, atol_bf16=5e-2)

    def jloss(p):
        out, _ = jm.apply_batch(p, jnp.asarray(obs), ())
        return jnp.sum(out.logits * c1) + jnp.sum(out.value * c2)

    def tloss(p):
        out, _ = tm.apply_batch(p, _t(obs), {})
        return (out.logits * _t(c1)).sum() + (out.value * _t(c2)).sum()

    ref_g = _jax_grads(jloss, masters) if mode != "fp32" else None
    _check_grads(mode, _torch_grads(tp, tloss), _jax_grads(jloss, jp), ref_g)
