"""The episode transformer's mixture of experts and its lockstep step,
held against the JAX package's, on the CPU.

Same converted weights, same observations and carries (numpy, from a seed)
through every pass of the episode model with ``moe_experts=4`` at
``moe_top_k`` 0 (dense-mask top-1) and 2 (capacity top-k at capacity factor
0.5, so picks drop): ``_prefill``, ``_incremental_serve`` at heterogeneous
``t``, the lockstep ``apply_batch`` over 3 ticks (the dense model too) and
``apply`` for one session, ``apply_unroll``, ``apply_unroll_shared`` with a
representative that is not row 0, and ``apply_rollout_trunk`` (hn and the
carry); each returns logits, values and the balance loss as aux (the trunk
drops it). Then one PPO chunk at top-2 in both packages from the same
converted state, the JAX step's own draws handed in; and at top-0 the
rollout's stored log-probabilities against the replay's, as the JAX
package's own test holds them (``tests/test_models.py``, 3e-4). Last,
``parallel/moe.route_hook`` replays a recorded routing bit for bit.

Size: L 2, H 2, Dh 16, window 12, 4 experts; every block's gate is scaled
by ``GATE_SCALE`` (as ``tests/test_torch_window_transformer.py`` does) so
that the routing is not near uniform. The JAX side runs its reference
attention (``use_pallas=False``).

Tolerances (float32, absolute): logits and values 1e-4, aux 1e-5, K/V
1e-4, hist and t exact; the PPO chunk as ``tests/test_torch_ppo.py`` holds
it (params 1e-5, adagrad sums 1e-5 + 1e-3 relative, metrics 1e-4 + 1e-4
relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.agents import build_agent as jax_build_agent
from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.env import trading as jtrading
from sharetrade_tpu.models.transformer_episode import (
    episode_transformer_policy as jax_policy)
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.agents import build_agent
from sharetrade_tpu_torch.agents.ppo import Draws
from sharetrade_tpu_torch.agents.rollout import (
    collect_rollout, replay_forward)
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.env.trading import make_trading_env
from sharetrade_tpu_torch.models.transformer_episode import (
    episode_transformer_policy as torch_policy)

WINDOW, EXPERTS, GATE_SCALE = 12, 4, 50.0
HIST = WINDOW - 1                      # (L - 1) * (window - 1) at L 2
TOL = {"logits": 1e-4, "value": 1e-4, "aux": 1e-5, "kv": 1e-4}
FFNS = {"dense": {}, "top0": dict(moe_experts=EXPERTS),
        "top2": dict(moe_experts=EXPERTS, moe_top_k=2,
                     moe_capacity_factor=0.5)}


def _prices(rng, length):
    steps = rng.uniform(0.01, 0.03, length) * rng.choice([-1.0, 1.0], length)
    return (50.0 * np.exp(np.cumsum(steps))).astype(np.float32)


def _t(x):
    return convert._tensor(np.asarray(x), "cpu")


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


_PAIRS = {}


def _pair(ffn):
    """(jax model, port model, jax params, port params), built once."""
    if ffn not in _PAIRS:
        kw = dict(num_layers=2, num_heads=2, head_dim=16, **FFNS[ffn])
        jm = jax_policy(WINDOW + 2, 3, use_pallas=False, **kw)
        tm = torch_policy(WINDOW + 2, 3, device="cpu", **kw)
        jp = jm.init(jax.random.PRNGKey(11))
        for blk in jp["blocks"]:
            if "moe" in blk:
                blk["moe"]["gate"] = blk["moe"]["gate"] * GATE_SCALE
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp))
        _PAIRS[ffn] = (jm, tm, jp, tp)
    return _PAIRS[ffn]


def _obs(rng, prices, starts):
    """(B, obs_dim) observations of windows starting at ``starts``."""
    wins = np.stack([prices[s:s + WINDOW] for s in starts])
    budget = rng.uniform(0.0, 3000.0, (len(starts), 1))
    shares = rng.integers(0, 6, (len(starts), 1)).astype(np.float64)
    return np.concatenate([wins, budget, shares], axis=1).astype(np.float32)


def _trajectory(rng, prices, t0, t_len, bsz):
    """(T, B, obs_dim) lockstep observations from cursor t0."""
    return np.stack([_obs(rng, prices, [t0 + t] * bsz)
                     for t in range(t_len)])


def _check_out(tout, jout, msg=""):
    _close(tout.logits, jout.logits, TOL["logits"], msg + " logits")
    _close(tout.value, jout.value, TOL["value"], msg + " value")
    _close(tout.aux, jout.aux, TOL["aux"], msg + " aux")


def _check_carry(tc, jc, msg=""):
    for key in ("k", "v"):
        _close(tc[key], jc[key], TOL["kv"], msg + " " + key)
    for key in ("hist", "t"):
        np.testing.assert_array_equal(np.asarray(tc[key]),
                                      np.asarray(jc[key]), err_msg=msg + key)


@pytest.mark.parametrize("ffn", list(FFNS))
def test_init_tree_matches(ffn):
    """The port's own init draws the JAX tree: ``blocks[i]["moe"]`` in
    place of ``mlp_in`` / ``mlp_out``."""
    jm, tm, jp, _ = _pair(ffn)
    want = {k: v.shape for k, v in convert.flatten(
        jax.tree.map(np.asarray, jp)).items()}
    got = {k: v.shape for k, v in convert.flatten(convert.params_to_numpy(
        tm.init(torch.Generator().manual_seed(0)))).items()}
    assert got == want
    assert ("blocks.0.moe.w_in" in got) == (ffn != "dense")


@pytest.mark.parametrize("ffn", ["top0", "top2"])
def test_prefill_and_serving_step_match_jax(ffn):
    """A batch of fresh sessions through the prefill, then one serving
    step at heterogeneous ``t`` from a carry made with numpy."""
    jm, tm, jp, tp = _pair(ffn)
    rng = np.random.default_rng(1)
    prices = _prices(rng, 80)
    fresh = _obs(rng, prices, [0, 3, 9, 20, 41])
    bsz = 5
    carry = {"k": rng.standard_normal((bsz, 2, 2, WINDOW, 16)),
             "v": rng.standard_normal((bsz, 2, 2, WINDOW, 16)),
             "hist": np.stack([prices[i:i + HIST] for i in range(bsz)]),
             "t": np.array([1, 4, 12, 13, 30], np.int32)}
    carry = {k: np.asarray(v, np.float32 if k != "t" else np.int32)
             for k, v in carry.items()}
    obs = _obs(rng, prices, [5, 8, 16, 17, 33])
    # One program for both passes: one compile.
    (jpre, jpre_carry), (jout, jcarry) = jax.jit(
        lambda p, f, o, c: (jm.apply_prefill(p, f),
                            jm.apply_serve_batch(p, o, c)))(
        jp, jnp.asarray(fresh), jnp.asarray(obs),
        jax.tree.map(jnp.asarray, carry))
    with torch.no_grad():
        tpre, tpre_carry = tm.apply_prefill(tp, _t(fresh))
        tout, tcarry = tm.apply_serve_batch(
            tp, _t(obs), {k: _t(v).clone() for k, v in carry.items()})
    _check_out(tpre, jpre, "prefill")
    _check_carry(tpre_carry, jpre_carry, "prefill")
    assert float(tpre.aux) > 0.0
    _check_out(tout, jout, "serve")
    _check_carry(tcarry, jcarry, "serve")


@pytest.mark.parametrize("ffn", list(FFNS))
def test_lockstep_apply_batch_matches_jax(ffn):
    """Three lockstep ticks from the init carry (a prefill, then two
    one-token steps into the one ring slot ``(t[0] - 1) mod window``); then
    ``apply`` for one session against its batch row."""
    jm, tm, jp, tp = _pair(ffn)
    rng = np.random.default_rng(2)
    prices = _prices(rng, 60)
    bsz = 3
    c0 = jax.tree.map(lambda x: np.broadcast_to(x, (bsz,) + x.shape),
                      jm.init_carry())
    jcarry = jax.tree.map(jnp.asarray, c0)
    tcarry = {k: _t(v).clone() for k, v in c0.items()}
    jstep = jax.jit(jm.apply_batch)
    for tick in range(3):
        obs = _obs(rng, prices, [tick] * bsz)
        jout, jcarry = jstep(jp, jnp.asarray(obs), jcarry)
        with torch.no_grad():
            tout, tcarry = tm.apply_batch(tp, _t(obs), tcarry)
        _check_out(tout, jout, f"tick {tick}")
        _check_carry(tcarry, jcarry, f"tick {tick}")
    one = {k: v[1] for k, v in tcarry.items()}
    obs = _obs(rng, prices, [3] * bsz)
    with torch.no_grad():
        batch_out, _ = tm.apply_batch(tp, _t(obs), tcarry)
        out, carry1 = tm.apply(tp, _t(obs[1]), one)
    if ffn != "top2":       # top-k routing depends on the batch's rows
        _close(out.logits, batch_out.logits[1], 1e-6)
    assert out.logits.shape == (3,) and int(carry1["t"]) == 4
    ragged = {**tcarry, "t": torch.tensor([3, 3, 4], dtype=torch.int32)}
    with pytest.raises(ValueError, match="lockstep"):
        tm.apply_batch(tp, _t(obs), ragged)


@pytest.mark.parametrize("ffn", ["top0", "top2"])
def test_replays_and_trunk_match_jax(ffn):
    """``apply_unroll`` and ``apply_unroll_shared`` from a mid-episode
    carry whose row 0 is poisoned (NaN hist) and whose row 1 is quarantined
    mid-unroll, so the shared replay elects row 2; ``apply_rollout_trunk``
    from the same carry."""
    jm, tm, jp, tp = _pair(ffn)
    rng = np.random.default_rng(3)
    prices = _prices(rng, 60)
    bsz, t0, t_len = 3, 12, 9
    carry = {"k": rng.standard_normal((bsz, 2, 2, WINDOW, 16)),
             "v": rng.standard_normal((bsz, 2, 2, WINDOW, 16)),
             "hist": np.broadcast_to(prices[t0 - HIST:t0], (bsz, HIST)),
             "t": np.full((bsz,), t0, np.int32)}
    carry = {k: np.array(v, np.float32 if k != "t" else np.int32)
             for k, v in carry.items()}
    obs = _trajectory(rng, prices, t0, t_len, bsz)
    ticks = np.broadcast_to(prices[t0 + WINDOW:t0 + WINDOW + t_len],
                            (bsz, t_len)).copy()
    with torch.no_grad():
        tt_hn, tt_carry = tm.apply_rollout_trunk(
            tp, _t(obs[0]), _t(ticks), {k: _t(v) for k, v in carry.items()})
    trunk_obs = obs[0].copy()

    obs[5:, 1] = 0.0
    poisoned = {**carry, "hist": carry["hist"].copy()}
    poisoned["hist"][0, 2] = np.nan
    tc = {k: _t(v) for k, v in poisoned.items()}
    # One program for the three passes: one compile.
    jt, *jreplays = jax.jit(lambda p, o0, tk, c, o, pc: (
        jm.apply_rollout_trunk(p, o0, tk, c), jm.apply_unroll(p, o, pc),
        jm.apply_unroll_shared(p, o, pc)))(
        jp, jnp.asarray(trunk_obs), jnp.asarray(ticks),
        jax.tree.map(jnp.asarray, carry), jnp.asarray(obs),
        jax.tree.map(jnp.asarray, poisoned))
    _close(tt_hn, jt[0], 1e-4, "trunk hn")
    _check_carry(tt_carry, jt[1], "trunk")
    for name, (jl, jv, jaux) in zip(("apply_unroll", "apply_unroll_shared"),
                                    jreplays):
        with torch.no_grad():
            tl, tv, taux = getattr(tm, name)(tp, _t(obs), tc)
        rows = [2] if name == "apply_unroll" else [0, 1, 2]
        _close(tl[:, rows], np.asarray(jl)[:, rows], TOL["logits"], name)
        _close(tv[:, rows], np.asarray(jv)[:, rows], TOL["value"], name)
        if name == "apply_unroll_shared":
            _close(taux, jaux, TOL["aux"], name + " aux")
            assert float(taux) > 0.0


AGENTS, UNROLL, EPOCHS = 8, 16, 2
PPO = ["learner.algo=ppo", "model.kind=transformer", "model.seq_mode=episode",
       "model.num_layers=2", "model.num_heads=2", "model.head_dim=16",
       f"model.moe_experts={EXPERTS}", f"env.window={WINDOW}",
       f"parallel.num_workers={AGENTS}", f"runtime.chunk_steps={UNROLL}",
       f"learner.ppo_epochs={EPOCHS}", "learner.ppo_minibatches=2"]


def _agents(*extra):
    prices = _prices(np.random.default_rng(0), 80)
    overrides = PPO + list(extra)
    jagent = jax_build_agent(JaxConfig().apply_overrides(overrides),
                             jtrading.make_trading_env(prices, window=WINDOW))
    tenv = make_trading_env(prices, window=WINDOW, device="cpu")
    tagent = build_agent(FrameworkConfig().apply_overrides(overrides), tenv,
                         device="cpu")
    return jagent, tagent, tenv


def test_one_ppo_chunk_at_top2_matches_jax():
    jagent, tagent, _ = _agents("model.moe_top_k=2",
                                "model.moe_capacity_factor=0.5")
    jts = jagent.init(jax.random.PRNGKey(3))
    tts = convert.train_state_from_jax(jax.tree.map(np.asarray, jts))
    rng, k_noise = jax.random.split(jts.rng)
    gumbel = jax.random.gumbel(k_noise, (UNROLL, AGENTS, 3), jnp.float32)
    perms = []
    for _ in range(EPOCHS):
        rng, k_perm = jax.random.split(rng)
        perms.append(np.asarray(jax.random.permutation(k_perm, AGENTS)))
    jts2, jm = jax.jit(jagent.step)(jts)
    tts2, tm = tagent.step(tts, draws=Draws(torch.tensor(np.asarray(gumbel)),
                                            torch.tensor(np.stack(perms))))
    t = convert.train_state_to_numpy(tts2)
    for field in ("t", "budget", "shares", "share_value"):
        np.testing.assert_array_equal(
            t["env_state"][field], np.asarray(getattr(jts2.env_state, field)),
            err_msg=field)
    assert int(t["updates"]) == int(jts2.updates) == EPOCHS * 2
    jflat = convert.flatten(jax.tree.map(np.asarray, jts2.params))
    tflat = convert.flatten(t["params"])
    assert sorted(jflat) == sorted(tflat)
    assert any(".moe." in k for k in tflat)
    for k in jflat:
        np.testing.assert_allclose(tflat[k], jflat[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    for got, want in zip(
            jax.tree.leaves(t["opt_state"][0].sum_of_squares),
            jax.tree.leaves(jts2.opt_state[0].sum_of_squares)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-3)
    for key in ("k", "v"):
        _close(t["carry"][key], jts2.carry[key], TOL["kv"], key)
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-4, atol=1e-4, err_msg=key)


def test_top0_rollout_logp_matches_the_replay():
    """Dense-mask top-1 routes each token alone, so the rollout's trunk
    (one row of hist + window + T ticks) and the shared replay (hist +
    window + T - 1) give the same log-probabilities; two chunks, the second
    from the first's carry; the balance loss is live."""
    _, tagent, tenv = _agents()
    ts = tagent.init(0)
    model = tagent.model
    for chunk in range(2):
        init_carry = ts.carry
        ts, traj, _, _ = collect_rollout(model, tenv, ts, 8, AGENTS)
        with torch.no_grad():
            logits, _, aux = replay_forward(model, ts.params, traj,
                                            init_carry)
        logp = torch.log_softmax(logits, dim=-1).gather(
            -1, traj.action[..., None])[..., 0]
        _close(logp, traj.logp, 3e-4, f"chunk {chunk}")
        assert float(aux) > 0.0


@pytest.mark.parametrize("ffn", ["top0", "top2"])
def test_route_hook_replays_a_routing(ffn):
    """``parallel/moe.route_hook``, the seam through which the smoke holds
    the kernel and plain attention at one routing: decisions recorded from
    a prefill and handed back give the same bits; other decisions handed
    in change the answer."""
    from sharetrade_tpu_torch.parallel import moe
    _, tm, _, tp = _pair(ffn)
    rng = np.random.default_rng(4)
    obs = _t(_obs(rng, _prices(rng, 60), [0, 5, 11]))
    pins = []

    def record(picks):
        pins.append(picks.clone())
        return picks

    def run(hook):
        moe.route_hook = hook
        try:
            with torch.no_grad():
                return tm.apply_prefill(tp, obs)[0]
        finally:
            moe.route_hook = None

    own = run(record)
    assert len(pins) == 2                          # one decision a layer
    calls = iter(pins)
    again = run(lambda picks: next(calls))
    assert torch.equal(again.logits, own.logits)
    assert torch.equal(again.value, own.value)
    calls = iter(pins)
    moved = run(lambda picks: (next(calls) + 1) % EXPERTS)
    assert not torch.equal(moved.value, own.value)
    assert moe.route_hook is None
