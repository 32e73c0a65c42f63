"""The episode transformer's training entries against the JAX package's.

Same converted weights, same observations and carries (numpy, from a seed)
through ``apply_rollout_trunk`` (hn_base and the carry after the unroll,
its K/V rolled into ring layout), ``rollout_head_factored``,
``apply_unroll``, ``apply_unroll_shared`` (with a representative that is
not row 0) and the parameter gradients of a scalar loss of the shared
replay. Small width (L 2, H 2, Dh 16, window 12), then once at the
flagship width (Dh 128, window 201, B 2, T 8). The JAX side runs its
reference attention (``use_pallas=False``): the attention's own gradients
are held against the interpret-mode Pallas kernels in
tests/test_torch_attention_grad.py, and the compiles of interpret-mode
programs would cost this file most of its time budget.

Prices follow a walk whose log-returns stay between 1% and 3% in magnitude
(see tests/test_torch_episode_model.py: near-zero returns turn one ulp of
``log`` into a large relative error of the tick features).

Tolerances (absolute unless stated):
- fp32: hidden states, logits, values 1e-4 (hidden entries up to ~5 after
  layer norm, summed in another order); K/V 1e-4; hist and t exact;
  gradients 1e-4 relative to the largest entry of each leaf's gradient;
- bf16_mixed: logits 5e-3, values 5e-2 (bf16 ulps of the heads' outputs);
  gradients within 5% in relative L2 over all leaves (bf16 rounds every
  activation, and the two libraries round at different points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.models.transformer_episode import (
    episode_transformer_policy as jax_policy)
from sharetrade_tpu.precision import PrecisionPolicy as JaxPolicy
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.models.transformer_episode import (
    episode_transformer_policy as torch_policy)
from sharetrade_tpu_torch.precision import PrecisionPolicy as TorchPolicy

F32 = {"hn": 1e-4, "logits": 1e-4, "value": 1e-4, "kv": 1e-4,
       "grad_rel": 1e-4}
BF16 = {"logits": 5e-3, "value": 5e-2, "grad_l2": 5e-2}


def _prices(rng, length):
    steps = rng.uniform(0.01, 0.03, length) * rng.choice([-1.0, 1.0], length)
    return (50.0 * np.exp(np.cumsum(steps))).astype(np.float32)


class _Pair:
    def __init__(self, window, head_dim, mode, use_pallas):
        self.window = window
        self.jm = jax_policy(window + 2, 3, num_layers=2, num_heads=2,
                             head_dim=head_dim, use_pallas=use_pallas)
        self.tm = torch_policy(window + 2, 3, num_layers=2, num_heads=2,
                               head_dim=head_dim, device="cpu")
        masters = self.jm.init(jax.random.PRNGKey(11))
        self.jpol, self.tpol = JaxPolicy(mode=mode), TorchPolicy(mode=mode)
        self.jp = self.jpol.cast_compute(masters)
        self.tp = self.tpol.cast_compute(
            convert.params_from_jax(jax.tree.map(np.asarray, masters)))

    def carry0(self, bsz):
        """The fresh batched carry both packages start an episode from."""
        c = jax.tree.map(lambda x: np.broadcast_to(x, (bsz,) + x.shape),
                         self.jm.init_carry())
        jc = self.jpol.cast_carry(jax.tree.map(jnp.asarray, c), self.jm)
        tc = self.tpol.cast_carry({k: convert._tensor(np.asarray(v), "cpu")
                                   for k, v in c.items()}, self.tm)
        return jc, tc


def _trajectory(rng, prices, t0, t_len, bsz, window):
    """(T, B, obs_dim) lockstep observations from cursor t0."""
    budget = rng.uniform(0.0, 3000.0, (t_len, bsz)).astype(np.float32)
    shares = rng.integers(0, 6, (t_len, bsz)).astype(np.float32)
    wins = np.stack([prices[t0 + t:t0 + t + window] for t in range(t_len)])
    obs = np.concatenate([np.broadcast_to(wins[:, None], (t_len, bsz, window)),
                          budget[..., None], shares[..., None]], axis=-1)
    return obs.astype(np.float32)


def _close(got, want, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0, err_msg=msg)


def _t(x):
    return convert._tensor(np.asarray(x), "cpu")


def _check_trunk_chain(pair, rng, tol, bsz=3, t_len=9):
    """Two consecutive unrolls' trunks (t0 = 0, then t0 = t_len), the
    second from the first's carry. Returns the second unroll's inputs."""
    window = pair.window
    prices = _prices(rng, 2 * t_len + window + 2)
    jtrunk = jax.jit(pair.jm.apply_rollout_trunk)
    jcarry, tcarry = pair.carry0(bsz)
    for t0 in (0, t_len):
        obs = _trajectory(rng, prices, t0, 1, bsz, window)[0]
        ticks = np.broadcast_to(prices[t0 + window:t0 + window + t_len],
                                (bsz, t_len)).copy()
        j_hn, jcarry_next = jtrunk(pair.jp, jnp.asarray(obs),
                                   jnp.asarray(ticks), jcarry)
        with torch.no_grad():
            t_hn, tcarry_next = pair.tm.apply_rollout_trunk(
                pair.tp, _t(obs), _t(ticks), tcarry)
        _close(t_hn.float(), j_hn.astype(jnp.float32), tol["hn"], "hn_base")
        for key in ("k", "v"):
            _close(tcarry_next[key].float(),
                   jcarry_next[key].astype(jnp.float32), tol["kv"], key)
        np.testing.assert_array_equal(tcarry_next["hist"].numpy(),
                                      np.asarray(jcarry_next["hist"]))
        np.testing.assert_array_equal(tcarry_next["t"].numpy(),
                                      np.asarray(jcarry_next["t"]))
        start = (jcarry, tcarry, prices, t0)
        jcarry, tcarry = jcarry_next, tcarry_next
    return start, j_hn, t_hn


_CHAINS = {}


def _chain(mode):
    """One small pair per precision mode and its checked trunk chain,
    built once per module (jit compiles dominate this file's time)."""
    if mode not in _CHAINS:
        pair = _Pair(12, 16, mode, use_pallas=False)
        rng = np.random.default_rng(0)
        tol = F32 if mode == "fp32" else {**F32, "hn": 1.0, "kv": 1.0}
        _CHAINS[mode] = (pair, rng) + _check_trunk_chain(pair, rng, tol)
    return _CHAINS[mode]


def test_trunk_and_factored_head_fp32():
    pair, rng, _, j_hn, t_hn = _chain("fp32")
    jl, jv, jpf = pair.jm.rollout_head_factored(pair.jp, j_hn[0])
    with torch.no_grad():
        tl, tv, tpf = pair.tm.rollout_head_factored(pair.tp, t_hn[0])
        obs = _trajectory(rng, _prices(rng, 40), 3, 1, 4, 12)[0]
        t_dl, t_dv = tpf(_t(obs))
    j_dl, j_dv = jpf(jnp.asarray(obs))
    for got, want in ((tl, jl), (tv, jv), (t_dl, j_dl), (t_dv, j_dv)):
        _close(got, want, F32["logits"])


def _replays(pair, obs, jcarry, tcarry):
    j_sh = jax.jit(pair.jm.apply_unroll_shared)(pair.jp, jnp.asarray(obs),
                                                jcarry)
    j_un = jax.jit(pair.jm.apply_unroll)(pair.jp, jnp.asarray(obs), jcarry)
    with torch.no_grad():
        t_sh = pair.tm.apply_unroll_shared(pair.tp, _t(obs), tcarry)
        t_un = pair.tm.apply_unroll(pair.tp, _t(obs), tcarry)
    return (j_sh, t_sh), (j_un, t_un)


@pytest.mark.parametrize("mode", ["fp32", "bf16_mixed"])
def test_replays_with_a_representative_past_row_zero(mode):
    """Row 0's carry is poisoned (NaN hist) and row 1's tail quarantined
    (zeroed observations), so both packages elect row 2; the replays of
    the healthy rows match, and the shared replay matches apply_unroll on
    them."""
    tol = F32 if mode == "fp32" else BF16
    pair, rng, (jcarry, tcarry, prices, t0), _, _ = _chain(mode)
    obs = _trajectory(rng, prices, t0, 9, 3, 12)
    obs[5:, 1] = 0.0
    jhist = np.asarray(jcarry["hist"]).copy()
    jhist[0, 2] = np.nan
    jcarry = {**jcarry, "hist": jnp.asarray(jhist)}
    tcarry = {**tcarry, "hist": _t(jhist)}
    (j_sh, t_sh), (j_un, t_un) = _replays(pair, obs, jcarry, tcarry)
    healthy = [2]
    for (jl, jv, _), (tl, tv, _) in ((j_sh, t_sh), (j_un, t_un)):
        _close(tl[:, healthy], np.asarray(jl)[:, healthy], tol["logits"])
        _close(tv[:, healthy], np.asarray(jv)[:, healthy], tol["value"])
    # The shared replay's other rows use row 2's trunk with their own
    # wallets, as the JAX package's does.
    _close(t_sh[0], j_sh[0], tol["logits"])
    _close(t_sh[1], j_sh[1], tol["value"])


def _loss_weights(rng, t_len, bsz):
    return (rng.standard_normal((t_len, bsz, 3)).astype(np.float32),
            rng.standard_normal((t_len, bsz)).astype(np.float32))


def _grads(pair, obs, jcarry, tcarry, w_l, w_v):
    """Per-leaf gradients of a weighted sum of the shared replay's logits
    and values, ``{name: (port, jax)}``, and the replay's outputs
    ``((port logits, values), (jax logits, values))``."""
    def jloss(p):
        logits, values, _ = pair.jm.apply_unroll_shared(
            p, jnp.asarray(obs), jcarry)
        return jnp.sum(logits * w_l) + jnp.sum(values * w_v), (logits, values)

    (_, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(pair.jp)
    jg = jax.tree.map(lambda x: np.asarray(x, np.float32), jg)
    names = sorted(convert.flatten(convert.params_to_numpy(pair.tp)))
    tensors = {}

    def attach(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: attach(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [attach(v, f"{prefix}.{i}") for i, v in enumerate(tree)]
        tensors[prefix] = tree.detach().clone().requires_grad_()
        return tensors[prefix]

    params = attach(pair.tp)
    logits, values, _ = pair.tm.apply_unroll_shared(params, _t(obs), tcarry)
    loss = (logits * _t(w_l)).sum() + (values * _t(w_v)).sum()
    tg = torch.autograd.grad(loss, [tensors[n] for n in names])
    jflat = convert.flatten(jg)
    return ({n: (g.float().numpy(), jflat[n]) for n, g in zip(names, tg)},
            (logits.detach(), values.detach()), jout)


@pytest.mark.parametrize("mode", ["fp32", "bf16_mixed"])
def test_parameter_grads_of_the_shared_replay(mode):
    pair, rng, (jcarry, tcarry, prices, t0), _, _ = _chain(mode)
    obs = _trajectory(rng, prices, t0, 9, 3, 12)
    grads, _, _ = _grads(pair, obs, jcarry, tcarry,
                         *_loss_weights(rng, 9, 3))
    assert len(grads) == 34             # 2 blocks x 12 + 10 top-level leaves
    if mode == "fp32":
        for name, (got, want) in grads.items():
            scale = max(np.abs(want).max(), 1e-6)
            np.testing.assert_allclose(got / scale, want / scale,
                                       atol=F32["grad_rel"], rtol=0,
                                       err_msg=name)
    else:
        got = np.concatenate([g.ravel() for g, _ in grads.values()])
        want = np.concatenate([w.ravel() for _, w in grads.values()])
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < BF16["grad_l2"], rel


def test_flagship_width_replay_and_grads():
    """Dh 128, window 201: the replay's banded pass over 200 + 201 + 7
    ticks, fp32, against the JAX reference attention."""
    pair = _Pair(201, 128, "fp32", use_pallas=False)
    rng = np.random.default_rng(3)
    prices = _prices(rng, 230)
    jcarry, tcarry = pair.carry0(2)
    obs = _trajectory(rng, prices, 0, 8, 2, 201)
    grads, (tl, tv), (jl, jv) = _grads(pair, obs, jcarry, tcarry,
                                       *_loss_weights(rng, 8, 2))
    _close(tl, jl, F32["logits"])
    _close(tv, jv, F32["value"])
    for name, (got, want) in grads.items():
        scale = max(np.abs(want).max(), 1e-6)
        np.testing.assert_allclose(got / scale, want / scale,
                                   atol=F32["grad_rel"], rtol=0, err_msg=name)
