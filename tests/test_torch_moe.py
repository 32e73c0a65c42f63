"""The port's single-device mixture-of-experts FFN against the JAX
package's (``parallel/moe.py``), on the CPU.

Inputs: numpy-seeded tokens and expert banks (d 16, hidden 32, 4 experts),
the same arrays handed to both packages. Cases: the dense-mask top-1
``moe_apply``; the capacity top-k ``moe_apply_topk`` at token counts below,
equal to and above the routing group (with a zero-padded tail group), at
the default capacity and at one low enough to drop picks; a gate whose
logits tie (both packages pick the lower expert index first).

Tolerances, float32: outputs and aux within 1e-5 absolute + 1e-5
relative (the same products summed in another order); gradients of
``sum(out * cot) + aux`` with respect to tokens and every parameter within
1e-4 absolute + 1e-4 relative (sums over up to 160 tokens). The routing
itself (which picks survive) must be identical: the dispatch masks are
compared exactly. bfloat16 (one top-k case): outputs and aux within 2e-2
absolute + one bf16 ulp (2^-7) relative (bf16 rounds each product and
sum at other points in the two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sharetrade_tpu.parallel import moe as jmoe
from sharetrade_tpu_torch.parallel import moe as tmoe

D, HIDDEN, EXPERTS = 16, 32, 4


def _params(seed=0, gate_scale=1.0):
    rng = np.random.default_rng(seed)
    return {
        "gate": (rng.standard_normal((D, EXPERTS)) * gate_scale).astype(
            np.float32),
        "w_in": (rng.standard_normal((EXPERTS, D, HIDDEN))
                 * (2.0 / D) ** 0.5).astype(np.float32),
        "w_out": (rng.standard_normal((EXPERTS, HIDDEN, D))
                  * (2.0 / HIDDEN) ** 0.5).astype(np.float32),
    }


def _tokens(n, seed=1):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)


def _both(fn_j, fn_t, params, tokens, cot):
    """Outputs, aux and gradients (w.r.t. tokens and params) of
    ``sum(out * cot) + aux`` in both packages."""
    def jloss(p, x):
        out, aux = fn_j(p, x)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(tokens, requires_grad=True)
    tout, taux = fn_t(tp, tx)
    ((tout * torch.from_numpy(cot)).sum() + taux).backward()
    return (np.asarray(jout), float(jaux), jgrads), \
        (tout.detach().numpy(), float(taux.detach()), ({k: v.grad.numpy()
                                                for k, v in tp.items()},
                                               tx.grad.numpy()))


def _assert_match(j, t):
    (jout, jaux, (jgp, jgx)), (tout, taux, (tgp, tgx)) = j, t
    np.testing.assert_allclose(tout, jout, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(taux, jaux, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tgx, np.asarray(jgx), atol=1e-4, rtol=1e-4)
    for k in tgp:
        np.testing.assert_allclose(tgp[k], np.asarray(jgp[k]), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("n", [7, 96])
def test_moe_apply_dense_top1(n):
    params, tokens = _params(), _tokens(n)
    cot = np.random.default_rng(2).standard_normal((n, D)).astype(np.float32)
    _assert_match(*_both(jmoe.moe_apply, tmoe.moe_apply, params, tokens,
                         cot))


@pytest.mark.parametrize("n,group,factor", [
    (40, 64, 1.25),      # below the group: one group of 40
    (64, 64, 1.25),      # exactly one group
    (150, 64, 1.25),     # three groups, the last zero-padded
    (150, 64, 0.25),     # capacity low enough to drop picks
    (1500, 1024, 1.25),  # the models' default group of 1,024
])
@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_apply_topk(n, group, factor, top_k):
    params, tokens = _params(), _tokens(n)
    cot = np.random.default_rng(3).standard_normal((n, D)).astype(np.float32)

    def jfn(p, x):
        return jmoe.moe_apply_topk(p, x, top_k=top_k, capacity_factor=factor,
                                   group_size=group)

    def tfn(p, x):
        return tmoe.moe_apply_topk(p, x, top_k=top_k, capacity_factor=factor,
                                   group_size=group)

    _assert_match(*_both(jfn, tfn, params, tokens, cot))


@pytest.mark.parametrize("n,group", [(40, 64), (150, 64), (64, 64)])
def test_padding_and_capacity_match(n, group):
    jt, jv = jmoe._pad_groups(jnp.asarray(_tokens(n)), group)
    tt, tv = tmoe._pad_groups(torch.from_numpy(_tokens(n)), group)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for g in (1, 7, 40, 64, 1024):
        for k in (1, 2):
            for f in (0.25, 1.0, 1.25, 2.0):
                assert tmoe._capacity(g, EXPERTS, k, f) == \
                    jmoe._capacity(g, EXPERTS, k, f)


def test_low_capacity_drops_the_same_picks():
    """At capacity factor 0.25 some picks overflow; both packages keep and
    drop exactly the same (token, pick) slots."""
    params, tokens = _params(gate_scale=3.0), _tokens(150)
    toks_j, valid_j = jmoe._pad_groups(jnp.asarray(tokens), 64)
    cap = jmoe._capacity(64, EXPERTS, 2, 0.25)
    logits = np.einsum("Gni,ie->Gne", np.asarray(toks_j), params["gate"])
    jd, jc, (ji, jl) = jmoe._topk_route(jnp.asarray(logits), 2, cap,
                                        jnp.float32, valid_j)
    td, tc, (ti, tl) = tmoe._topk_route(torch.from_numpy(logits), 2, cap,
                                        torch.float32,
                                        torch.tensor(np.asarray(valid_j)))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-6)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    kept = float(np.asarray(jd).sum())
    assert kept < 2 * 150                    # some picks were dropped
    assert kept > 0


def test_tied_gate_picks_the_lower_expert():
    """An all-zero gate gives every expert the same probability: top-1
    picks expert 0 and top-2 experts 0 and 1, in both packages."""
    params = _params()
    params["gate"] = np.zeros_like(params["gate"])
    tokens = _tokens(48)
    cot = np.random.default_rng(4).standard_normal((48, D)).astype(np.float32)
    _assert_match(*_both(jmoe.moe_apply, tmoe.moe_apply, params, tokens,
                         cot))

    def jfn(p, x):
        return jmoe.moe_apply_topk(p, x, top_k=2, group_size=1024)

    def tfn(p, x):
        return tmoe.moe_apply_topk(p, x, top_k=2, group_size=1024)

    _assert_match(*_both(jfn, tfn, params, tokens, cot))
    d, _, _ = tmoe._topk_route(torch.zeros((1, 48, EXPERTS)), 2, 64,
                               torch.float32)
    per_expert = d.sum(dim=(0, 1, 3))
    assert per_expert.tolist() == [48.0, 48.0, 0.0, 0.0]


def test_topk_bf16():
    params, tokens = _params(), _tokens(150)
    jout, jaux = jmoe.moe_apply_topk(
        jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params),
        jnp.asarray(tokens, jnp.bfloat16), top_k=2, group_size=64)
    tout, taux = tmoe.moe_apply_topk(
        {k: torch.from_numpy(v).bfloat16() for k, v in params.items()},
        torch.from_numpy(tokens).bfloat16(), top_k=2, group_size=64)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32), atol=2e-2,
                               rtol=2.0 ** -7)
    np.testing.assert_allclose(float(taux), float(jaux), atol=2e-2,
                               rtol=2.0 ** -7)
