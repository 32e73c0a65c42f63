"""Hot weight swaps in the port (``serve/swap.py`` ``WeightSwapWatcher`` and
``ServeEngine.swap_params``), on the CPU: the JAX package's tests
(tests/test_serve.py:353-455, tests/test_serve_robustness.py:436-488)
mirrored on the port, and the CLI's wiring.

- Atomicity under load: while twelve client threads load the engine,
  ``tag_best`` advances three times through the port's checkpoint manager
  and the watcher swaps each in. Every response names one published step,
  every tick's responses name the same step, and each response's logits
  recompute under its step's weights (within ``ATOL + RTOL * |logit|``:
  the engine's padded batch and the B = 1 recomputation are float32
  products summed in another order, on logits of order 10) and sit
  farther than ``APART`` from every other version's.
- A corrupt candidate (a byte of its ``state.npz`` flipped) is refused and
  quarantined; the engine serves on, on its old weights.
- The breaker: consecutive refusals open it (the gauge, the counter, no
  verification while open); after the cooldown a good candidate closes it.
- A tag the JAX package wrote is passed over and left as it is.
- The watcher waits for a checkpoint directory that does not exist yet,
  and its own thread swaps at its poll.
- ``cli serve --params`` keeps the weights it was given against the tag as
  it stood at start, and swaps in a newer save.
"""

import json
import os
import pathlib
import subprocess
import sys
import threading
import types

import jax
import numpy as np
import pytest
import torch

from sharetrade_tpu_torch.agents.base import TrainState
from sharetrade_tpu_torch.checkpoint import CheckpointManager
from sharetrade_tpu_torch.config import ModelConfig, ServeConfig
from sharetrade_tpu_torch.models import build_model
from sharetrade_tpu_torch.serve import ServeEngine, WeightSwapWatcher
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

REPO = pathlib.Path(__file__).resolve().parents[1]
WINDOW = 8
OBS_DIM = WINDOW + 2
ATOL = 1e-5
RTOL = 1e-6
APART = 1e-3


@pytest.fixture(scope="module")
def mlp():
    return build_model(ModelConfig(kind="mlp", hidden_dim=16), OBS_DIM,
                       device="cpu")


@pytest.fixture(scope="module")
def prices():
    rng = np.random.default_rng(7)
    return rng.uniform(10.0, 20.0, 256).astype(np.float32)


def obs_at(prices, start, t, *, shares=0.0):
    lo = start + t
    return np.concatenate([prices[lo:lo + WINDOW],
                           [2400.0, shares]]).astype(np.float32)


def _state(params, updates: int) -> TrainState:
    """A TrainState holding only ``params`` (enough for ``save_tagged`` and
    a params-only restore)."""
    zero = torch.zeros(())
    return TrainState(
        params=params, opt_state=({},), carry={},
        env_state=types.SimpleNamespace(t=zero, budget=zero, shares=zero,
                                        share_value=zero),
        rng=torch.Generator(), env_steps=torch.zeros((), dtype=torch.int32),
        updates=torch.tensor(updates, dtype=torch.int32))


def _corrupt_tag(root) -> None:
    path = os.path.join(root, "tag_best", "state.npz")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))


def _logits(model, params, obs) -> np.ndarray:
    out, _ = model.apply_batch(params, torch.from_numpy(obs[None]), {})
    return out.logits[0].numpy()


def _engine(model, params, step=1, registry=None):
    engine = ServeEngine(model, ServeConfig(max_batch=4, slots=8,
                                            batch_timeout_ms=1.0),
                         params, params_step=step,
                         registry=registry or MetricsRegistry())
    engine.warmup()
    return engine


def test_hot_swap_atomicity_under_load(mlp, prices, tmp_path):
    """Twelve client threads (more than the cores) with a shortened thread
    switch interval, so a tick torn between two weights would show."""
    versions = {k: mlp.init(torch.Generator().manual_seed(10 + k))
                for k in range(1, 5)}
    manager = CheckpointManager(str(tmp_path / "ckpt"), fsync=False)
    manager.save_tagged("best", _state(versions[1], 1),
                        metadata={"updates": 1})
    registry = MetricsRegistry()
    engine = _engine(mlp, versions[1], registry=registry)
    watcher = WeightSwapWatcher(engine, manager, versions[1], tag="best",
                                poll_s=60.0,
                                seen_meta=manager.tagged_metadata("best"))
    results: list = []
    cv = threading.Condition()
    stop = threading.Event()

    def load(worker):
        i = 0
        while not stop.is_set():
            obs = obs_at(prices, (i * 3 + worker) % 100, 0,
                         shares=float(i % 5))
            result = engine.submit(f"load{worker}-{i % 3}", obs).wait(10.0)
            if result is not None:
                with cv:
                    results.append((obs, result))
                    cv.notify_all()
            i += 1

    def wait_for(n):
        with cv:
            assert cv.wait_for(lambda: len(results) >= n, 30.0)

    threads = [threading.Thread(target=load, args=(w,), daemon=True)
               for w in range(12)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    for thread in threads:
        thread.start()
    try:
        for k in range(2, 5):
            wait_for(len(results) + 40)
            manager.save_tagged("best", _state(versions[k], k),
                                metadata={"updates": k})
            assert watcher.poll_once()
            assert engine.params_step == k
        wait_for(len(results) + 40)
    finally:
        stop.set()
        for thread in threads:
            thread.join(10.0)
        sys.setswitchinterval(interval)
        engine.stop()
    assert not any(thread.is_alive() for thread in threads)
    assert registry.counters()["serve_swaps_total"] == 3.0
    by_tick: dict = {}
    for obs, result in results:
        step = result.params_step
        assert step in versions
        by_tick.setdefault(result.batch, set()).add(step)
        want = _logits(mlp, versions[step], obs)
        np.testing.assert_allclose(result.logits, want, atol=ATOL, rtol=RTOL)
        for other, params in versions.items():
            if other != step:
                assert np.abs(result.logits - _logits(mlp, params, obs)
                              ).max() > APART
    assert all(len(steps) == 1 for steps in by_tick.values())
    assert len({r.params_step for _, r in results}) == 4


def test_corrupt_swap_candidate_refused_serving_continues(mlp, prices,
                                                          tmp_path):
    v1 = mlp.init(torch.Generator().manual_seed(21))
    v2 = mlp.init(torch.Generator().manual_seed(22))
    root = str(tmp_path / "ckpt")
    manager = CheckpointManager(root, fsync=False)
    registry = MetricsRegistry()
    engine = _engine(mlp, v1, registry=registry)
    watcher = WeightSwapWatcher(engine, manager, v1, poll_s=60.0)
    try:
        manager.save_tagged("best", _state(v2, 2), metadata={"updates": 2})
        _corrupt_tag(root)
        assert watcher.poll_once() is False
        assert watcher.rejected == 1 and watcher.poll_once() is False
        assert registry.counters()["serve_swap_rejected_total"] == 1.0
        assert engine.params_step == 1
        obs = obs_at(prices, 0, 0)
        result = engine.submit("still-up", obs).wait(30.0)
        assert result is not None and result.params_step == 1
        np.testing.assert_allclose(result.logits, _logits(mlp, v1, obs),
                                   atol=ATOL, rtol=RTOL)
        assert any(n.startswith("corrupt_") for n in os.listdir(root))
    finally:
        engine.stop()


def test_swap_breaker_opens_and_recovers(mlp, prices, tmp_path):
    root = str(tmp_path / "ckpt")
    manager = CheckpointManager(root, fsync=False)
    registry = MetricsRegistry()
    v1 = mlp.init(torch.Generator().manual_seed(31))
    engine = _engine(mlp, v1, registry=registry)
    watcher = WeightSwapWatcher(engine, manager, v1, poll_s=60.0,
                                breaker_failures=2, breaker_cooldown_s=0.2)
    try:
        for k in (2, 3):
            manager.save_tagged("best", _state(mlp.init(
                torch.Generator().manual_seed(40 + k)), k),
                metadata={"updates": k})
            _corrupt_tag(root)
            assert watcher.poll_once() is False
        assert watcher.rejected == 2 and watcher.breaker_opens == 1
        assert watcher.breaker_open is True
        assert registry.latest("serve_swap_breaker_open") == 1.0
        assert registry.counters()["serve_swap_breaker_opens_total"] == 1.0
        manager.save_tagged("best", _state(mlp.init(
            torch.Generator().manual_seed(44)), 4), metadata={"updates": 4})
        _corrupt_tag(root)
        assert watcher.poll_once() is False
        assert watcher.rejected == 2, "an open breaker still verified"
        cooled = threading.Event()
        while not cooled.wait(0.01):        # the cooldown runs out
            if not watcher.breaker_open:
                cooled.set()
        v5 = mlp.init(torch.Generator().manual_seed(45))
        manager.save_tagged("best", _state(v5, 5), metadata={"updates": 5})
        assert watcher.poll_once() is True
        assert engine.params_step == 5 and watcher.breaker_open is False
        assert registry.latest("serve_swap_breaker_open") == 0.0
        assert engine.submit("up", obs_at(prices, 0, 0)).wait(30.0)
    finally:
        engine.stop()


def test_a_tag_of_the_jax_package_is_passed_over(mlp, tmp_path):
    """The JAX manager's ``tag_best`` in the directory: the watcher neither
    swaps nor counts a refusal, and the JAX files stay as they were."""
    import jax.numpy as jnp

    from sharetrade_tpu.agents.base import TrainState as JaxTrainState
    from sharetrade_tpu.checkpoint.manager import CheckpointManager as JaxMgr
    from sharetrade_tpu.config import ModelConfig as JaxModelConfig
    from sharetrade_tpu.models import build_model as jax_build

    jm = jax_build(JaxModelConfig(kind="mlp", hidden_dim=16), OBS_DIM,
                   head="ac")
    root = str(tmp_path / "ckpt")
    JaxMgr(root, fsync=False).save_tagged(
        "best", JaxTrainState(params=jm.init(jax.random.PRNGKey(0)),
                              opt_state=(), carry=(), env_state=(),
                              rng=jax.random.PRNGKey(0),
                              env_steps=jnp.int32(0), updates=jnp.int32(7)),
        metadata={"updates": 7})
    before = sorted(os.listdir(os.path.join(root, "tag_best")))
    registry = MetricsRegistry()
    v1 = mlp.init(torch.Generator().manual_seed(1))
    engine = _engine(mlp, v1, registry=registry)
    watcher = WeightSwapWatcher(engine, CheckpointManager(root, fsync=False),
                                v1, poll_s=60.0, breaker_failures=1)
    try:
        assert watcher.poll_once() is False and watcher.poll_once() is False
        assert watcher.rejected == 0 and watcher.breaker_opens == 0
        assert engine.params_step == 1
        assert sorted(os.listdir(os.path.join(root, "tag_best"))) == before
        assert not any(n.startswith("corrupt_") for n in os.listdir(root))
    finally:
        engine.stop()


def test_watcher_waits_for_the_directory_and_swaps_on_its_thread(
        mlp, tmp_path):
    root = str(tmp_path / "later")
    opened: list = []

    def manager():
        if not os.path.isdir(root):
            return None
        opened.append(CheckpointManager(root, fsync=False))
        return opened[-1]

    v1 = mlp.init(torch.Generator().manual_seed(1))
    engine = _engine(mlp, v1, step=0)
    swapped = threading.Event()
    real_swap = engine.swap_params

    def swap_params(params, step):
        real_swap(params, step)
        swapped.set()

    engine.swap_params = swap_params
    watcher = WeightSwapWatcher(engine, manager, v1, poll_s=0.05)
    try:
        assert watcher.poll_once() is False and not os.path.exists(root)
        watcher.start()
        CheckpointManager(root, fsync=False).save_tagged(
            "best", _state(mlp.init(torch.Generator().manual_seed(2)), 3),
            metadata={"updates": 3})
        assert swapped.wait(30.0)
        assert engine.params_step == 3 and len(opened) == 1
    finally:
        watcher.stop()
        engine.stop()
    assert not watcher._thread.is_alive()


def _cli_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_serve_params_keeps_its_weights_until_a_newer_save(tmp_path):
    """``cli serve --params`` with a ``tag_best`` already in the checkpoint
    directory: the watcher (0.1 s polls) leaves the given weights alone
    (no swap, params_step 0); a tag saved after start swaps in."""
    from sharetrade_tpu_torch.agents import build_agent
    from sharetrade_tpu_torch.config import FrameworkConfig
    from sharetrade_tpu_torch.convert import save_npz
    from sharetrade_tpu_torch.env.trading import make_trading_env

    sets = ["data.synthetic_length=316", "env.window=16",
            "model.hidden_dim=16", "serve.max_batch=4", "serve.slots=8",
            "serve.swap_poll_s=0.1"]
    cfg = FrameworkConfig().apply_overrides(sets)
    model = build_agent(cfg, make_trading_env(
        np.linspace(10.0, 20.0, 40, dtype=np.float32), window=16,
        device="cpu"), device="cpu").model
    ckpt = tmp_path / "checkpoints"
    manager = CheckpointManager(str(ckpt), fsync=False)
    manager.save_tagged("best", _state(model.init(
        torch.Generator().manual_seed(5)), 9), metadata={"updates": 9})
    save_npz(str(tmp_path / "p.npz"),
             model.init(torch.Generator().manual_seed(6)))
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
           "--device", "cpu", "--params", str(tmp_path / "p.npz"),
           "--duration", "30", "--sessions", "8"]
    for item in sets:
        cmd += ["--set", item]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=tmp_path,
                            env=_cli_env())
    try:
        ready = json.loads(proc.stdout.readline())
        assert ready["event"] == "serving_ready" and ready["swap_watcher"]
        assert ready["params_step"] == 0
        manager.save_tagged("best", _state(model.init(
            torch.Generator().manual_seed(7)), 11), metadata={"updates": 11})
        for line in proc.stderr:
            if "swapped to step" in line:
                assert "step 11" in line
                break
        proc.terminate()
        rest, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    summary = json.loads(rest.strip().splitlines()[-1])
    assert proc.returncode == 75 and summary["preempted"]
    assert summary["swaps"] == 1 and summary["params_step"] == 11
    assert summary["swap_rejected"] == 0 and summary["failed"] == 0
