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
