"""The port's window-mode transformer against the JAX package's, on the
CPU, and the stateless replay's batch-major fold.

Same converted weights (JAX init, ``convert.params_from_jax``), same
numpy-seeded observations: price windows from a walk whose log-returns stay
between 1% and 3% in magnitude (see tests/test_torch_episode_model.py for
why), budgets and share counts. Size: window 16, L 2, H 2, Dh 16, 6 rows;
single-asset (A = 1, 17 tokens) and the 2-asset portfolio layout (A = 2,
34 tokens, 5 actions); the dense FFN and a 4-expert MoE FFN, top-0 (the
dense-mask top-1) and top-2. The JAX side's ``flash_attention`` runs its
XLA reference on the CPU; the port's runs the plain version.

Tolerances:
- fp32: logits, values and aux within 1e-5 absolute + 1e-5 relative; the
  gradient of ``sum(logits * c1) + sum(values * c2) + aux`` within 1e-4
  absolute + 1e-4 relative on every leaf (sums over the tokens taken in
  another order).
- bf16 compute copy (``precision.mode=bf16_mixed``): logits within 5e-3
  and values within 5e-2 absolute, as tests/test_torch_episode_model.py
  holds the episode transformer (logits of order 0.1, values of order 1,
  bf16 ulp 2^-7 relative); aux within 2e-2. The gradients pass every
  rounding twice, at points the two libraries place differently, so they
  are held against the JAX float32 model, as JAX's own bf16 model is: with
  e(leaf) the L2 norm of a leaf's difference from the float32 gradient
  relative to that gradient's norm, the port's mean e over the leaves
  must be at most twice JAX's bf16 mean plus 2^-8 (the rule
  ``chip_smoke.py`` applies to a minibatch, MB_FACTOR / MB_FLOOR), and
  every leaf's e at most twice JAX's plus 2^-4 (a wrong or missing
  gradient has e near 1). The MoE routes each token by a discrete choice
  on its bf16 gate logits; at the init's gate std of 0.01 the best experts
  of many tokens lie within a few bf16 ulps, and either library's bf16
  model may route them otherwise than the float32 model does (the
  isolated MoE's bf16 gradients then lie ~14% from the float32 ones in
  both packages). So the bf16 MoE cases scale the gate by
  ``BF16_GATE_SCALE``: every choice has a margin far above the rounding,
  and the comparison measures the arithmetic. The float32 cases keep the
  init's gate; tests/test_torch_moe.py compares the routing exactly.
- The replay fold: ``agents/rollout.replay_forward`` with the MoE top-2 at
  capacity factor 0.5 over a 16-step x 8-agent trajectory (128 rows x 17
  tokens = 2,176 tokens, three routing groups of 1,024, picks dropped in
  each): logits, values and aux within 1e-5 absolute + 1e-5 relative, the
  gradients within 1e-4 absolute + 1e-4 relative, with the JAX fold cap
  and with a cap of 40 rows (four fold groups) in both packages. A
  time-major fold routes other tokens together and drops other picks: it
  misses these tolerances by orders of magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.agents import rollout as jrollout
from sharetrade_tpu.models.transformer import transformer_policy as jax_policy
from sharetrade_tpu.precision import PrecisionPolicy as JaxPolicy
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import rollout as trollout
from sharetrade_tpu_torch.models.transformer import (
    transformer_policy as torch_policy)
from sharetrade_tpu_torch.precision import PrecisionPolicy as TorchPolicy

WINDOW, ROWS = 16, 6
#: The bf16 cases' gate scale: routing decisions with a margin far above
#: bf16 rounding (see the module docstring).
BF16_GATE_SCALE = 50.0
FFNS = {"dense": dict(), "moe_top0": dict(moe_experts=4),
        "moe_top2": dict(moe_experts=4, moe_top_k=2)}


def _obs(rng, rows, assets):
    steps = rng.uniform(0.01, 0.03, (rows, assets, WINDOW)) * rng.choice(
        [-1.0, 1.0], (rows, assets, WINDOW))
    windows = 50.0 * np.exp(np.cumsum(steps, axis=-1))
    budget = rng.uniform(0.0, 3000.0, (rows, 1))
    shares = rng.integers(0, 6, (rows, assets)).astype(np.float64)
    return np.concatenate([windows.reshape(rows, -1), budget, shares],
                          axis=1).astype(np.float32)


def _pair(assets, ffn, gate_scale=1.0, **extra):
    obs_dim = assets * WINDOW + 1 + assets
    kw = dict(num_layers=2, num_heads=2, head_dim=16, num_assets=assets,
              **FFNS[ffn], **extra)
    jm = jax_policy(obs_dim, 2 * assets + 1, **kw)
    tm = torch_policy(obs_dim, 2 * assets + 1, device="cpu", **kw)
    jp = jm.init(jax.random.PRNGKey(11))
    for blk in jp["blocks"]:
        if "moe" in blk:
            blk["moe"]["gate"] = blk["moe"]["gate"] * gate_scale
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
    return jm, tm, jp, tp


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.mark.parametrize("assets", [1, 2])
@pytest.mark.parametrize("ffn", list(FFNS))
def test_init_tree_matches(assets, ffn):
    """The port's own init draws the JAX tree: names, shapes, dtypes."""
    jm, tm, jp, _ = _pair(assets, ffn)
    want = {k: (v.shape, v.dtype) for k, v in convert.flatten(
        jax.tree.map(np.asarray, jp)).items()}
    got = {k: (v.shape, v.dtype) for k, v in convert.flatten(
        convert.params_to_numpy(
            tm.init(torch.Generator().manual_seed(0)))).items()}
    assert got == want
    assert ("asset" in jp) == (assets > 1)


def _cotangents(obs, actions):
    rng = np.random.default_rng(5)
    return (rng.standard_normal((obs.shape[0], actions)).astype(np.float32),
            rng.standard_normal((obs.shape[0],)).astype(np.float32))


def _jax_forward_and_grads(jm, jp, obs, mode):
    c1, c2 = _cotangents(obs, jm.num_actions)

    def jloss(p):
        out, _ = jm.apply_batch(p, jnp.asarray(obs), ())
        return (jnp.sum(out.logits * c1) + jnp.sum(out.value * c2)
                + out.aux, out)

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        JaxPolicy(mode=mode).cast_compute(jp))
    return jout, convert.flatten(jax.tree.map(
        lambda a: np.asarray(a, np.float32), jg))


def _forward_and_grads(jm, tm, jp, tp, obs, mode):
    c1, c2 = _cotangents(obs, jm.num_actions)
    jout, jflat = _jax_forward_and_grads(jm, jp, obs, mode)
    tpc = TorchPolicy(mode=mode).cast_compute(tp)
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in convert.flatten(tpc, leaf=lambda x: x).items()}
    tout, carry = tm.apply_batch(convert.unflatten(leaves),
                                 torch.from_numpy(obs), {})
    assert carry == {}
    ((tout.logits * torch.from_numpy(c1)).sum()
     + (tout.value * torch.from_numpy(c2)).sum() + tout.aux).backward()
    tflat = {k: v.grad for k, v in leaves.items()}
    return jout, tout, jflat, tflat


@pytest.mark.parametrize("assets", [1, 2])
@pytest.mark.parametrize("ffn", list(FFNS))
@pytest.mark.parametrize("mode", ["fp32", "bf16_mixed"])
def test_forward_and_grads_match(assets, ffn, mode):
    jm, tm, jp, tp = _pair(assets, ffn,
                           gate_scale=BF16_GATE_SCALE if mode != "fp32"
                           else 1.0)
    obs = _obs(np.random.default_rng(3), ROWS, assets)
    jout, tout, jg, tg = _forward_and_grads(jm, tm, jp, tp, obs, mode)
    assert tout.logits.shape == (ROWS, 2 * assets + 1)
    assert tout.logits.dtype == tout.value.dtype == torch.float32
    assert sorted(tg) == sorted(jg)
    logits, value = tout.logits.detach(), tout.value.detach()
    aux = float(tout.aux.detach())
    if ffn == "dense":
        assert aux == float(jout.aux) == 0.0
    if mode == "fp32":
        for got, want in ((logits, jout.logits), (value, jout.value)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(aux, float(jout.aux), atol=1e-5,
                                   rtol=1e-5)
        for k in jg:
            np.testing.assert_allclose(tg[k].numpy(), jg[k], atol=1e-4,
                                       rtol=1e-4, err_msg=k)
        return
    assert abs(aux - float(jout.aux)) <= 2e-2
    np.testing.assert_allclose(logits.numpy(), np.asarray(jout.logits),
                               atol=5e-3, rtol=0)
    np.testing.assert_allclose(value.numpy(), np.asarray(jout.value),
                               atol=5e-2, rtol=0)
    _, ref_g = _jax_forward_and_grads(jm, jp, obs, "fp32")
    port_e, jax_e = {}, {}
    for k in jg:
        assert tg[k].dtype == torch.bfloat16, k
        port_e[k] = _rel_l2(tg[k].float().numpy(), ref_g[k])
        jax_e[k] = _rel_l2(jg[k], ref_g[k])
        assert port_e[k] <= 2 * jax_e[k] + 2 ** -4, (k, port_e[k], jax_e[k])
    assert np.mean(list(port_e.values())) <= \
        2 * np.mean(list(jax_e.values())) + 2 ** -8


# ---------------------------------------------------------------------------
# the replay fold
# ---------------------------------------------------------------------------

T_STEPS, AGENTS = 16, 8


def _replay_both(cap, monkeypatch):
    jm, tm, jp, tp = _pair(1, "moe_top2", moe_capacity_factor=0.5)
    rng = np.random.default_rng(9)
    obs = _obs(rng, T_STEPS * AGENTS, 1).reshape(T_STEPS, AGENTS, -1)
    c1 = rng.standard_normal((T_STEPS, AGENTS, 3)).astype(np.float32)
    c2 = rng.standard_normal((T_STEPS, AGENTS)).astype(np.float32)
    if cap is not None:
        monkeypatch.setattr(jrollout, "_MAX_FOLD_ROWS", cap)
        monkeypatch.setattr(trollout, "_MAX_FOLD_ROWS", cap)
    zeros = np.zeros((T_STEPS, AGENTS), np.float32)
    jtraj = jrollout.StepData(obs=jnp.asarray(obs),
                              action=jnp.zeros((T_STEPS, AGENTS), jnp.int32),
                              logp=zeros, value=zeros, reward=zeros,
                              active=zeros)

    def jloss(p):
        logits, values, aux = jrollout.replay_forward(jm, p, jtraj, ())
        return (jnp.sum(logits * c1) + jnp.sum(values * c2) + aux,
                (logits, values, aux))

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    z = torch.zeros((T_STEPS, AGENTS))
    ttraj = trollout.StepData(obs=torch.from_numpy(obs),
                              action=z.long(), logp=z, value=z, reward=z,
                              active=z)
    leaves = {k: v.clone().requires_grad_()
              for k, v in convert.flatten(tp, leaf=lambda x: x).items()}
    logits, values, aux = trollout.replay_forward(
        tm, convert.unflatten(leaves), ttraj, {})
    ((logits * torch.from_numpy(c1)).sum()
     + (values * torch.from_numpy(c2)).sum() + aux).backward()
    return jout, jg, (logits, values, aux), {
        k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("cap", [None, 40], ids=["jax_cap", "cap40"])
def test_replay_fold_matches_jax_under_moe_drops(cap, monkeypatch):
    from sharetrade_tpu.parallel import moe as jmoe
    tokens = T_STEPS * AGENTS * (WINDOW + 1)
    assert tokens > 2 * 1024                 # three routing groups
    # capacity 0.5: a group of 1,024 tokens x 2 picks has 4 x 256 slots.
    assert jmoe._capacity(1024, 4, 2, 0.5) * 4 < 2 * 1024
    jout, jg, tout, tg = _replay_both(cap, monkeypatch)
    for got, want in zip(tout, jout):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    jflat = convert.flatten(jax.tree.map(np.asarray, jg))
    for k, want in jflat.items():
        np.testing.assert_allclose(tg[k].numpy(), want, atol=1e-4, rtol=1e-4,
                                   err_msg=k)
