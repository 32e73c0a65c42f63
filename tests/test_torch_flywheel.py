"""The flywheel (``fleet/flywheel.py``, ``cli fleet --learner``) in the port
against the JAX package's, on the CPU.

- tests/test_fleet.py's flywheel cases on the port's classes: served
  sessions journal rows the learner's width (read back by both packages'
  ``read_new_transitions``), stamps a monotone row count continued across a
  writer restart, the episode-wrap row skipped.
- The same served actions through the JAX and the port sessions, over a
  series of prices on a 1/16 grid (every budget exact in float32 and
  float64 alike, so the two sessions' budgets agree): the two journals'
  records equal bit for bit (obs, action, reward, next_obs, stamps).
- The port's orchestrator ingests a session journal with no actor pool
  (``distrib.ingest_without_pool``): every journaled row once.
- ``cli fleet --learner --device cpu`` (one engine, an in-process DQN
  learner evaluating every 24 updates, the engine polling ``tag_best``
  every 0.2 s): ``fleet_ready`` names the learner, journaling sessions
  driven over the wire see ``params_step`` advance past the boot weights,
  and SIGTERM drains to exit 75 with ``rows_ingested`` > 0.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

from sharetrade_tpu.data.transitions import (
    read_new_transitions as jax_read_new_transitions)
from sharetrade_tpu.fleet.flywheel import (
    SessionTransitionJournal as JaxSessionJournal,
    make_journaling_sessions as jax_make_sessions)
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.data.journal import iter_framed_records
from sharetrade_tpu_torch.data.transitions import (
    decode_transitions, read_new_transitions)
from sharetrade_tpu_torch.fleet import FleetClient
from sharetrade_tpu_torch.fleet.flywheel import (
    JournalingSession, SessionTransitionJournal, make_journaling_sessions)
from sharetrade_tpu_torch.runtime import Orchestrator

WINDOW = 8
OBS_DIM = WINDOW + 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_sessions_journal_ingestible_rows(tmp_path):
    root = str(tmp_path / "actors")
    journal = SessionTransitionJournal(root, "fleet-w0", obs_dim=OBS_DIM,
                                       flush_rows=8)
    prices = np.linspace(10, 20, 64).astype(np.float32)
    sessions = make_journaling_sessions(prices, WINDOW, 3, journal=journal,
                                        seed=0)
    for step in range(10):
        for s in sessions:
            s.advance(action=step % 3)
    journal.flush()
    out = read_new_transitions(journal.path, 0, 10_000)
    obs, action, reward, next_obs, high_water = out
    assert obs.shape[1] == OBS_DIM and next_obs.shape == obs.shape
    assert np.isfinite(reward).all()
    rows0 = obs.shape[0]
    assert rows0 == journal.rows_journaled and high_water == rows0
    jax_out = jax_read_new_transitions(journal.path, 0, 10_000)
    for a, b in zip(out, jax_out):
        np.testing.assert_array_equal(a, b)
    journal.close()
    # A writer restart continues past the recovered high-water.
    journal2 = SessionTransitionJournal(root, "fleet-w0", obs_dim=OBS_DIM,
                                        flush_rows=4)
    session = make_journaling_sessions(prices, WINDOW, 1, journal=journal2,
                                       seed=1)[0]
    for _ in range(4):
        session.advance(action=0)
    journal2.close()
    out2 = read_new_transitions(journal.path, rows0, 10_000)
    assert out2[0].shape[0] == 4 and out2[4] == rows0 + 4


def test_the_wrap_boundary_row_is_skipped(tmp_path):
    journal = SessionTransitionJournal(str(tmp_path / "a"), "w",
                                       obs_dim=OBS_DIM, flush_rows=1)
    prices = np.linspace(10, 20, WINDOW + 2).astype(np.float32)
    sess = JournalingSession("s", prices, WINDOW, 0, journal=journal)
    sess.advance(0)                          # t 0 -> 1: one row
    gen = sess.generation
    sess.advance(0)                          # wraps: no row
    assert sess.generation == gen + 1
    journal.close()
    assert read_new_transitions(journal.path, 0, 100)[0].shape[0] == 1


def _records(path):
    return [decode_transitions(p) for _, p in iter_framed_records(path)]


def test_the_journal_is_the_jax_sessions_bit_for_bit(tmp_path):
    rng = np.random.default_rng(4)
    prices = (160 + np.cumsum(rng.integers(-8, 9, 48))).astype(
        np.float32) / 16.0                   # a 1/16 grid around 10
    journals, served = [], []
    for cls, make, tag in ((JaxSessionJournal, jax_make_sessions, "jax"),
                           (SessionTransitionJournal,
                            make_journaling_sessions, "torch")):
        journal = cls(str(tmp_path / tag), "w0", obs_dim=OBS_DIM,
                      flush_rows=5)
        sessions = make(prices, WINDOW, 3, journal=journal, seed=2)
        actions = np.random.default_rng(9).integers(0, 3, (60, 3))
        for row in actions:                  # past the series end: a wrap
            for s, a in zip(sessions, row):
                s.advance(int(a))
        journal.close()
        journals.append(_records(journal.path))
        served.append(journal.rows_journaled)
    assert served[0] == served[1] > 0
    jax_recs, torch_recs = journals
    assert len(jax_recs) == len(torch_recs) > 1
    for a, b in zip(jax_recs, torch_recs):
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(x.view(np.uint32) if
                                          x.dtype == np.float32 else x,
                                          y.view(np.uint32) if
                                          y.dtype == np.float32 else y)
        assert a[4] == b[4]
    rewards = np.concatenate([r[2] for r in torch_recs])
    assert (rewards != 0).any()              # trades moved the portfolio


def test_the_learner_ingests_a_session_journal_once(tmp_path):
    cfg = FrameworkConfig().apply_overrides([
        "learner.algo=dqn", f"env.window={WINDOW}", "model.hidden_dim=8",
        "parallel.num_workers=4", "runtime.chunk_steps=12",
        "learner.replay_capacity=256", "learner.replay_batch=8",
        "distrib.ingest_without_pool=true",
        f"distrib.actor_dir={tmp_path / 'actors'}",
        f"runtime.checkpoint_dir={tmp_path / 'ckpt'}",
        f"data.journal_dir={tmp_path / 'journal'}"])
    prices = np.linspace(10, 20, 72).astype(np.float32)
    journal = SessionTransitionJournal(cfg.distrib.actor_dir, "fleet-w0",
                                       obs_dim=OBS_DIM, flush_rows=16)
    sessions = make_journaling_sessions(prices, WINDOW, 4, journal=journal)
    for step in range(20):
        for s in sessions:
            s.advance(step % 3)
    journal.close()
    orch = Orchestrator(cfg, device="cpu")
    orch.send_training_data(prices)
    rows = journal.rows_journaled
    assert rows > 60
    assert orch.ingest_actor_feeds() == rows
    assert orch.ingest_actor_feeds() == 0
    assert int(orch._ts.extras.replay.size) == rows
    assert orch.actor_feeds == {"fleet-w0": {"rows": rows, "cursor": rows}}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_cli_fleet_learner_on_the_cpu(tmp_path):
    sets = ["learner.algo=dqn", f"env.window={WINDOW}", "model.hidden_dim=8",
            "parallel.num_workers=4", "runtime.chunk_steps=12",
            "learner.replay_capacity=256", "learner.replay_batch=8",
            "data.synthetic_length=120", "runtime.episodes=100000",
            "runtime.eval_every_updates=24", "serve.swap_poll_s=0.2",
            "runtime.metrics_every_chunks=1",
            "serve.max_batch=8", "serve.slots=16"]
    cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli", "fleet",
           "--device", "cpu", "--engines", "1", "--learner"]
    for item in sets:
        cmd += ["--set", item]
    out_path = tmp_path / "fleet.out"
    with open(out_path, "wb") as out, open(tmp_path / "fleet.err",
                                           "wb") as err:
        proc = subprocess.Popen(cmd, stdout=out, stderr=err, cwd=tmp_path,
                                env=_env())
    try:
        ready = None
        deadline = time.monotonic() + 90.0
        while ready is None and time.monotonic() < deadline:
            assert proc.poll() is None, (tmp_path / "fleet.err").read_text()
            for line in out_path.read_text().splitlines():
                if '"fleet_ready"' in line:
                    ready = json.loads(line)
            time.sleep(0.1)
        assert ready is not None and ready["learner"] is True
        journal = SessionTransitionJournal(str(tmp_path / "actors"), "w0",
                                           obs_dim=OBS_DIM, flush_rows=8)
        # The learner's width; the prices need not be its series.
        prices = np.linspace(10, 20, 120).astype(np.float32)
        sessions = make_journaling_sessions(prices, WINDOW, 4,
                                            journal=journal)
        client = FleetClient(ready["host"], ready["port"])
        steps = set()
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline and max(steps, default=0) <= 0:
            for s in sessions:
                reply = client.submit(s.sid, s.observation())
                s.advance(int(reply["action"]))
                steps.add(int(reply["params_step"]))
            journal.flush()
        client.close()
        journal.close()
        assert max(steps) > 0, steps         # the learner's tag_best served
        deadline = time.monotonic() + 60.0   # the learner's first ingest
        while "ingested" not in (tmp_path / "fleet.err").read_text():
            assert time.monotonic() < deadline, "the learner never ingested"
            time.sleep(0.1)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60.0) == 75, (tmp_path / "fleet.err").read_text()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    summary = json.loads(out_path.read_text().splitlines()[-1])
    assert summary["preempted"] is True and summary["learner_restarts"] == 0
    assert 0 < summary["rows_ingested"] <= journal.rows_journaled
    assert summary["learner_updates"] > 0
