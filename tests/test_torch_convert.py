"""Weights carried from the JAX package into the port and back, bitwise.

JAX ``init`` -> numpy -> ``convert.params_from_jax`` ->
``convert.params_to_numpy`` must give back every leaf with the same dtype,
shape and bytes; so must the ``.npz`` file route (``save_npz`` /
``load_npz``) that ``cli serve --params`` reads. The port's own seeded init
must build the same tree (paths and shapes) as the JAX init.
"""

import jax
import numpy as np
import pytest
import torch

from sharetrade_tpu.models.transformer_episode import episode_transformer_policy
from sharetrade_tpu_torch import convert
from sharetrade_tpu_torch.models.transformer_episode import (
    episode_transformer_policy as torch_policy)

OBS_DIM = 14        # window 12


def _jax_params(layers):
    model = episode_transformer_policy(OBS_DIM, 3, num_layers=layers,
                                       num_heads=2, head_dim=16,
                                       use_pallas=False)
    params = model.init(jax.random.PRNGKey(layers))
    return jax.tree.map(np.asarray, params)


def _assert_same_tree(got, want):
    flat_got, flat_want = convert.flatten(got), convert.flatten(want)
    assert sorted(flat_got) == sorted(flat_want)
    for path, leaf in flat_want.items():
        assert flat_got[path].dtype == leaf.dtype, path
        assert flat_got[path].shape == leaf.shape, path
        assert np.array_equal(flat_got[path], leaf), path


@pytest.mark.parametrize("layers", [1, 2])
def test_round_trip_is_bitwise(layers):
    tree = _jax_params(layers)
    params = convert.params_from_jax(tree)
    assert isinstance(params["blocks"][0]["qkv"]["w"], torch.Tensor)
    assert len(params["blocks"]) == layers
    _assert_same_tree(convert.params_to_numpy(params), tree)


@pytest.mark.parametrize("layers", [1, 2])
def test_npz_round_trip_is_bitwise(layers, tmp_path):
    tree = _jax_params(layers)
    path = str(tmp_path / "params.npz")
    convert.save_npz(path, tree)
    _assert_same_tree(convert.params_to_numpy(convert.load_npz(path)), tree)


def test_dense_layout_is_in_out_without_transpose():
    tree = _jax_params(2)
    params = convert.params_from_jax(tree)
    w = params["blocks"][1]["mlp_in"]["w"]
    assert tuple(w.shape) == (32, 128)          # (in = d_model, out = 4 d)
    assert np.array_equal(w.numpy(), tree["blocks"][1]["mlp_in"]["w"])


@pytest.mark.parametrize("layers", [1, 2])
def test_port_init_builds_the_jax_tree(layers):
    model = torch_policy(OBS_DIM, 3, num_layers=layers, num_heads=2,
                         head_dim=16, device="cpu")
    ours = convert.flatten(convert.params_to_numpy(
        model.init(torch.Generator().manual_seed(0))))
    theirs = convert.flatten(_jax_params(layers))
    assert sorted(ours) == sorted(theirs)
    for path in theirs:
        assert ours[path].shape == theirs[path].shape, path
        assert ours[path].dtype == theirs[path].dtype, path


# ---------------------------------------------------------------------------
# optimizer state and whole training states
# ---------------------------------------------------------------------------

def _jax_train_state(optimizer, mode):
    """A JAX PPO TrainState (numpy leaves) a chunk into training, so the
    moments, counters, env state and carry are all non-trivial."""
    from sharetrade_tpu.agents import build_agent
    from sharetrade_tpu.config import FrameworkConfig
    from sharetrade_tpu.env.trading import make_trading_env

    cfg = FrameworkConfig().apply_overrides([
        "learner.algo=ppo", "model.kind=transformer",
        "model.seq_mode=episode", "model.head_dim=16", "model.num_heads=2",
        "env.window=12", "parallel.num_workers=4", "runtime.chunk_steps=8",
        "learner.ppo_epochs=1", "learner.ppo_minibatches=1",
        f"learner.optimizer={optimizer}", f"precision.mode={mode}"])
    prices = 50.0 + np.cumsum(np.random.default_rng(0).uniform(
        -1, 1, 60)).astype(np.float32)
    agent = build_agent(cfg, make_trading_env(prices, window=12))
    ts, _ = jax.jit(agent.step)(agent.init(jax.random.PRNGKey(0)))
    return jax.tree.map(np.asarray, ts)


def _assert_same_leaves(got, want):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("optimizer", ["adagrad", "adam", "sgd"])
def test_opt_state_round_trip_is_bitwise(optimizer):
    ts = _jax_train_state(optimizer, "fp32")
    port = convert.opt_state_from_jax(ts.opt_state)
    back = convert.opt_state_to_numpy(port)
    assert [type(s).__name__ for s in back] == [
        type(s).__name__ for s in ts.opt_state]
    assert back[0]._fields == ts.opt_state[0]._fields
    _assert_same_leaves(tuple(back[0]), tuple(ts.opt_state[0]))


@pytest.mark.parametrize("mode", ["fp32", "bf16_mixed"])
def test_train_state_round_trip_is_bitwise(mode, tmp_path):
    """JAX TrainState -> port -> numpy, and through an .npz file (there
    a bf16 carry travels as float32 and the policy's cast restores it)."""
    ts = _jax_train_state("adagrad", mode)
    port = convert.train_state_from_jax(ts)
    assert port.carry["k"].dtype == (torch.bfloat16 if mode == "bf16_mixed"
                                     else torch.float32)
    back = convert.train_state_to_numpy(port)
    _assert_same_leaves(back["params"], ts.params)
    _assert_same_leaves(tuple(back["opt_state"][0]), tuple(ts.opt_state[0]))
    _assert_same_leaves(back["carry"], ts.carry)
    for field in ("t", "budget", "shares", "share_value"):
        _assert_same_leaves(back["env_state"][field],
                            getattr(ts.env_state, field))
    _assert_same_leaves([back["env_steps"], back["updates"]],
                        [ts.env_steps, ts.updates])

    path = str(tmp_path / "state.npz")
    convert.save_train_state_npz(path, ts)
    loaded = convert.load_train_state_npz(path)
    again = convert.train_state_to_numpy(loaded)
    _assert_same_leaves(again["params"], ts.params)
    _assert_same_leaves(tuple(again["opt_state"][0]), tuple(ts.opt_state[0]))
    for key in ("k", "v"):
        assert np.array_equal(again["carry"][key].astype(np.float32),
                              np.asarray(ts.carry[key], np.float32))
    _assert_same_leaves([again["carry"]["hist"], again["carry"]["t"]],
                        [ts.carry["hist"], ts.carry["t"]])
    # A bare params file is not a training state.
    convert.save_npz(str(tmp_path / "params.npz"), ts.params)
    assert convert.load_train_state_npz(str(tmp_path / "params.npz")) is None
