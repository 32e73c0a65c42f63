"""``utils/flops.py`` against the JAX package's, and every benchmark
configuration through the port's construction checks.

- For every configuration of ``benchmarks/run_all.py`` ``make_configs()``
  (carried over with ``to_dict`` / ``from_dict``), the port's
  ``train_flops_per_agent_step`` and ``forward_flops_per_obs`` equal the
  JAX functions' to the float: the same arithmetic in the same order.
- The peaks are the H100 data sheet's, keyed by the card's name; an
  unknown card and the CPU raise ``ValueError`` (the JAX module's TPU
  fallback is not ported).
- Every configuration but ``ppo_mlp_dp4_tp2`` passes ``check_ported``,
  ``build_model`` and ``build_agent`` on the CPU at its full width (no
  parameters are drawn: a build wires functions only); that one is
  refused with a message naming multi-device layouts.
"""

import importlib.util
import pathlib

import pytest

from sharetrade_tpu.utils import flops as jflops
from sharetrade_tpu_torch.agents import build_agent
from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.data.synthetic import synthetic_price_series
from sharetrade_tpu_torch.env.trading import make_trading_env
from sharetrade_tpu_torch.models import build_model
from sharetrade_tpu_torch.runtime.orchestrator import check_ported
from sharetrade_tpu_torch.utils import flops

_RUN_ALL = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
            / "run_all.py")
_spec = importlib.util.spec_from_file_location("run_all", _RUN_ALL)
run_all = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(run_all)
JAX_CONFIGS = run_all.make_configs()
MULTI_DEVICE = "ppo_mlp_dp4_tp2"


def _port(name):
    return FrameworkConfig.from_dict(JAX_CONFIGS[name].to_dict())


@pytest.mark.parametrize("name", sorted(JAX_CONFIGS))
def test_flops_equal_the_jax_functions(name):
    jcfg, cfg = JAX_CONFIGS[name], _port(name)
    obs_dim = cfg.env.window + 2
    assert flops.train_flops_per_agent_step(cfg, obs_dim) == \
        jflops.train_flops_per_agent_step(jcfg, obs_dim)
    assert flops.forward_flops_per_obs(cfg.model, obs_dim,
                                       cfg.learner.algo) == \
        jflops.forward_flops_per_obs(jcfg.model, obs_dim, jcfg.learner.algo)
    assert flops.forward_equivalents_per_agent_step(
        cfg.learner, cfg.parallel.num_workers) == \
        jflops.forward_equivalents_per_agent_step(
            jcfg.learner, jcfg.parallel.num_workers)


@pytest.mark.parametrize("card, peaks", [
    ("NVIDIA H100 80GB HBM3", (989e12, 3.35e12)),
    ("NVIDIA H100 PCIe", (756e12, 2.0e12))])
def test_peaks_of_the_two_h100s(card, peaks):
    assert flops.peaks_for_name(card) == peaks
    assert flops.chip_peak_flops(name=card) == peaks[0]
    assert flops.chip_peak_hbm_bw(name=card) == peaks[1]
    cfg = _port("ppo_tr_episode_large_d1024")
    rate = 1234.5
    assert flops.mfu(rate, cfg, 203, name=card) == (
        rate * flops.train_flops_per_agent_step(cfg, 203) / peaks[0])


@pytest.mark.parametrize("device", ["cpu", None])
def test_no_peak_for_the_cpu_or_an_unknown_card(device):
    with pytest.raises(ValueError, match="no data-sheet peak"):
        flops.peaks_for_name("TPU v5 lite")
    if device is None and flops.torch.cuda.is_available():
        return                      # a card answers for the current device
    with pytest.raises(ValueError, match="no peak rate"):
        flops.chip_peak_flops(device)
    with pytest.raises(ValueError, match="no peak rate"):
        flops.mfu(1.0, _port("ppo_lstm"), 203, device)


@pytest.mark.parametrize(
    "name", sorted(n for n in JAX_CONFIGS if n != MULTI_DEVICE))
def test_every_single_device_config_builds(name):
    cfg = _port(name)
    check_ported(cfg)
    series = synthetic_price_series(length=cfg.data.synthetic_length)
    env = make_trading_env(series.prices, window=cfg.env.window,
                           device="cpu")
    head = "q" if cfg.learner.algo in ("qlearn", "dqn") else "ac"
    model = build_model(cfg.model, env.obs_dim, head=head, device="cpu")
    agent = build_agent(cfg, env, device="cpu")
    assert agent.model.name == model.name
    assert agent.num_agents == cfg.parallel.num_workers
    assert agent.steps_per_chunk == cfg.runtime.chunk_steps


def test_the_multi_device_config_is_refused():
    with pytest.raises(ConfigError, match="multi-device"):
        check_ported(_port(MULTI_DEVICE))
