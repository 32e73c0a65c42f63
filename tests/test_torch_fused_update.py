"""The port's fused optimizer update against the JAX package's, on the CPU.

On CPU tensors ``fused_apply`` runs the plain per-leaf math (optax's op
order) in place. The JAX side runs its ``fused_apply`` with the Pallas
kernel in interpret mode (``interpret=True``, leaves of 128 elements or
more) and the optax pair itself. The leaves include a (37, 13) matrix, a
(200,) vector and a scalar, so both of the JAX package's paths (Pallas and
the small-leaf XLA chain) are covered.

Tolerance: ``rtol 3e-7, atol 1e-7`` — about one float32 ulp, the bound
tests/test_precision.py states for the interpret-mode kernel against optax
(single-op evaluation vs XLA's contraction; here also the two libraries'
``rsqrt``). Three steps, so adam's count and bias corrections move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sharetrade_tpu.ops.fused_update import fused_apply as jax_fused_apply
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.ops import fused_update as tfu

RTOL, ATOL = 3e-7, 1e-7
STEPS = 3


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((37, 13), dtype=np.float32),
            "b": {"w": rng.standard_normal(200, dtype=np.float32),
                  "s": np.float32(0.5)}}


def _optax(name):
    return {"adagrad": optax.adagrad(0.01), "adam": optax.adam(0.01),
            "sgd": optax.sgd(0.01)}[name]


def _grads(step, dtype):
    return jax.tree.map(lambda x: (x * 0.37 + 0.01 * (step + 1)).astype(dtype),
                        _tree(1))


def _run_jax(name, dtype, *, interpret):
    params = jax.tree.map(jnp.asarray, _tree(0))
    state = _optax(name).init(params)
    for step in range(STEPS):
        params, state = jax_fused_apply(
            name, 0.01, jax.tree.map(jnp.asarray, _grads(step, dtype)),
            state, params, interpret=interpret)
    return jax.tree.map(np.asarray, (params, state))


def _run_optax(name, dtype):
    opt = _optax(name)
    params = jax.tree.map(jnp.asarray, _tree(0))
    state = opt.init(params)
    for step in range(STEPS):
        g = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.float32),
                         _grads(step, dtype))
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    return jax.tree.map(np.asarray, (params, state))


def _run_port(name, dtype):
    params = convert.params_from_jax(_tree(0))
    state = tfu.init_state(name, params)
    for step in range(STEPS):
        grads = convert.params_from_jax(_grads(step, dtype))
        out = tfu.fused_apply(name, 0.01, grads, state, params)
        assert out[0] is params and out[1] is state       # in place
    return (convert.params_to_numpy(params),
            convert.opt_state_to_numpy(state))


def _compare(port, ref):
    (tp, ts), (jp, js) = port, ref
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    tfields, jfields = ts[0]._asdict(), js[0]._asdict()
    assert sorted(tfields) == sorted(jfields)
    for key in jfields:
        for a, b in zip(jax.tree.leaves(tfields[key]),
                        jax.tree.leaves(jfields[key])):
            np.testing.assert_allclose(np.asarray(a, np.float64),
                                       np.asarray(b, np.float64),
                                       rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["adagrad", "adam", "sgd"])
def test_matches_jax_kernel_and_optax(name, dtype):
    port = _run_port(name, dtype)
    _compare(port, _run_jax(name, dtype, interpret=True))
    _compare(port, _run_optax(name, dtype))


def test_emit_compute_is_recast_of_new_masters():
    params = convert.params_from_jax(_tree(0))
    state = tfu.init_state("adagrad", params)
    grads = convert.params_from_jax(_grads(0, jnp.bfloat16))
    new, _, compute = tfu.fused_apply("adagrad", 0.01, grads, state, params,
                                      emit_compute=True)
    jparams = jax.tree.map(jnp.asarray, _tree(0))
    _, _, jcompute = jax_fused_apply(
        "adagrad", 0.01, jax.tree.map(jnp.asarray, _grads(0, jnp.bfloat16)),
        _optax("adagrad").init(jparams), jparams,
        compute_dtype=jnp.bfloat16, emit_compute=True, interpret=True)
    for m, c, jc in zip(jax.tree.leaves(convert.params_to_numpy(new)),
                        jax.tree.leaves(convert.params_to_numpy(compute)),
                        jax.tree.leaves(jax.tree.map(np.asarray, jcompute))):
        assert c.dtype == jnp.bfloat16
        np.testing.assert_array_equal(m.astype(jnp.bfloat16), c)
        np.testing.assert_allclose(c.astype(np.float32),
                                   jc.astype(np.float32), rtol=2.0 ** -8)


@pytest.mark.parametrize("mode", ["fp32", "bf16_mixed"])
def test_update_fn_hands_on_the_next_compute_copy(mode):
    """``make_update_fn`` returns the copy the next minibatch differentiates
    against: under bf16_mixed the exact bf16 recast of the updated masters,
    written by the update pass; in fp32 the masters themselves."""
    from sharetrade_tpu_torch.agents.base import Optimizer, make_update_fn
    from sharetrade_tpu_torch.models.core import tree_leaves
    from sharetrade_tpu_torch.precision import PrecisionPolicy

    policy = PrecisionPolicy(mode=mode)
    opt = Optimizer("adagrad", 0.01)
    params = convert.params_from_jax(_tree(0))
    grads = policy.cast_compute(convert.params_from_jax(_grads(0, np.float32)))
    new, _, compute = make_update_fn(opt, policy)(grads, opt.init(params),
                                                  params)
    assert new is params
    if mode == "fp32":
        assert compute is params
    else:
        for m, c in zip(tree_leaves(new), tree_leaves(compute)):
            assert c.dtype == torch.bfloat16
            assert torch.equal(c, m.to(torch.bfloat16))


def test_unsupported_optimizer_is_refused():
    params = convert.params_from_jax(_tree(0))
    with pytest.raises(ValueError, match="rmsprop"):
        tfu.fused_apply("rmsprop", 0.01, params, (), params)
