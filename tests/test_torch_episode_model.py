"""The port's episode transformer against the JAX package's, on the CPU.

Same converted weights, same observations (numpy, from a seed): the batched
prefill (``_prefill``) and then ``_incremental_serve`` steps at
HETEROGENEOUS per-row clocks — rows advance at different rates, each step
runs a different subset of rows, and the small model's K/V ring (window 12)
wraps — must give the same logits, values and carries (k, v, hist, t) in
both packages. The JAX side runs its Pallas kernel in interpret mode
(``use_pallas=True``) under ``jax.jit``.

Prices follow a walk whose log-returns stay between 1% and 3% in magnitude:
the tick features are log differences of neighbouring prices, and at a
return near zero the one-ulp difference between two libm ``log``s becomes
a large relative error that layer norm then passes on. Away from zero the
features agree to ~1e-5 relative.

Tolerances (absolute):
- fp32: logits and values 1e-5; K/V carries 1e-4 (entries up to ~6); hist
  and t exact.
- bf16_mixed: logits 5e-3 (order 0.1, policy std 0.01); values 5e-2 (order
  1, bf16 ulp 2^-7); K/V 1e-1 (entries up to ~6, bf16 ulp there 2^-5,
  and a few roundings apart after two layers); hist and t exact.
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

TOL = {
    "fp32": {"logits": 1e-5, "value": 1e-5, "kv": 1e-4},
    "bf16_mixed": {"logits": 5e-3, "value": 5e-2, "kv": 1e-1},
}


def _prices(rng, rows, length):
    steps = rng.uniform(0.01, 0.03, (rows, length)) * rng.choice(
        [-1.0, 1.0], (rows, length))
    return (50.0 * np.exp(np.cumsum(steps, axis=1))).astype(np.float32)


class _Pair:
    """Both packages' models with the same weights and precision."""

    def __init__(self, window, head_dim, mode):
        obs_dim = window + 2
        self.window = window
        self.jm = jax_policy(obs_dim, 3, num_layers=2, num_heads=2,
                             head_dim=head_dim, use_pallas=True)
        self.j_prefill = jax.jit(self.jm.apply_prefill)
        self.j_serve = jax.jit(self.jm.apply_serve_batch)
        self.tm = torch_policy(obs_dim, 3, num_layers=2, num_heads=2,
                               head_dim=head_dim, device="cpu")
        masters = self.jm.init(jax.random.PRNGKey(7))
        self.jp = JaxPolicy(mode=mode).cast_compute(masters)
        self.tp = TorchPolicy(mode=mode).cast_compute(
            convert.params_from_jax(jax.tree.map(np.asarray, masters)))
        self.tol = TOL[mode]

    def check(self, jout, jcarry, tout, tcarry):
        tol = self.tol
        np.testing.assert_allclose(tout.logits.numpy(),
                                   np.asarray(jout.logits),
                                   atol=tol["logits"], rtol=0)
        np.testing.assert_allclose(tout.value.numpy(),
                                   np.asarray(jout.value),
                                   atol=tol["value"], rtol=0)
        for key in ("k", "v"):
            assert tcarry[key].dtype == {
                jnp.float32: torch.float32,
                jnp.bfloat16: torch.bfloat16}[jcarry[key].dtype.type]
            np.testing.assert_allclose(
                tcarry[key].float().numpy(),
                np.asarray(jcarry[key].astype(jnp.float32)),
                atol=tol["kv"], rtol=0)
        assert tcarry["hist"].dtype == torch.float32
        np.testing.assert_array_equal(tcarry["hist"].numpy(),
                                      np.asarray(jcarry["hist"]))
        np.testing.assert_array_equal(tcarry["t"].numpy(),
                                      np.asarray(jcarry["t"]))


def _drive(window, head_dim, mode, rows, steps, seed):
    pair = _Pair(window, head_dim, mode)
    rng = np.random.default_rng(seed)
    prices = _prices(rng, rows, window + steps + 2)
    budget = rng.uniform(0.0, 3000.0, rows).astype(np.float32)
    shares = rng.integers(0, 6, rows).astype(np.float32)
    clock = np.zeros(rows, np.int64)

    def obs(sel):
        return np.stack([np.concatenate(
            [prices[b, clock[b]:clock[b] + window], [budget[b], shares[b]]])
            for b in sel]).astype(np.float32)

    everyone = list(range(rows))
    o = obs(everyone)
    jout, jcarry = pair.j_prefill(pair.jp, jnp.asarray(o))
    tout, tcarry = pair.tm.apply_prefill(pair.tp, torch.from_numpy(o))
    pair.check(jout, jcarry, tout, tcarry)
    for s in range(steps):
        sel = [b for b in everyone if s % (b + 1) == 0]   # row b every b+1
        for b in sel:
            clock[b] += 1
        o = obs(sel)
        idx = np.asarray(sel)
        jsub = jax.tree.map(lambda x: x[idx], jcarry)
        tsub = {k: v[idx].clone() for k, v in tcarry.items()}
        jout, jnew = pair.j_serve(pair.jp, jnp.asarray(o), jsub)
        tout, tnew = pair.tm.apply_serve_batch(pair.tp, torch.from_numpy(o),
                                               tsub)
        pair.check(jout, jnew, tout, tnew)
        jcarry = jax.tree.map(lambda full, sub: full.at[idx].set(sub),
                              jcarry, jnew)
        for k in tcarry:
            tcarry[k][idx] = tnew[k]
    pair.check(jout, jcarry, tout, tcarry)
    return clock


@pytest.mark.parametrize("mode", ["fp32", "bf16_mixed"])
def test_prefill_then_heterogeneous_serve_small(mode):
    clock = _drive(window=12, head_dim=16, mode=mode, rows=3, steps=16,
                   seed=3)
    # Row 0 stepped every time (its ring wrapped); the clocks differ.
    assert clock[0] == 16 and len(set(clock.tolist())) == 3


@pytest.mark.parametrize("mode", ["fp32", "bf16_mixed"])
def test_prefill_then_serve_flagship_width(mode):
    """L=2, H=2, Dh=128, window 201: the served model at full width."""
    clock = _drive(window=201, head_dim=128, mode=mode, rows=2, steps=3,
                   seed=5)
    assert clock.tolist() == [3, 2]
