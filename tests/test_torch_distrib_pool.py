"""The port's :class:`ActorPool` (``distrib/pool.py``): the supervision
ladder at process granularity, against tests/test_distrib.py's contract
and the JAX pool.

Stub children through the ``spawn_fn`` seam (a sleeper, a crasher), the
supervise thread parked so every tick is a test's ``poll_once``:

- the ladder: a crash backs off then respawns, the streak doubles the
  delay, a streak past the budget is terminal (the pool degrades, the
  corpse never respawns), a rolling heartbeat resets the streak, a dead
  incarnation's heartbeat is wiped at respawn; the seeded backoff schedule
  is the JAX pool's, delay for delay;
- membership: ``scale`` both ways, the ``scale`` control file (applied
  once per written value, a negative one ignored), a failed member not
  counted toward the target, quiesce (exits retire, scale refused),
  ``kill_all`` leaves no child;
- heartbeat timeout: a stamp older than the timeout kills the child into
  the ladder, whether it reached the rolling phase or not; timeout 0 only
  observes;
- status: ``status.json`` names every member, the gauges export, a torn or
  absent file reads None;
- without the seam the pool spawns the port's ``cli actor`` on its device.
"""

import json
import os
import random
import subprocess
import sys
import time

import pytest

from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.distrib import ladder as jladder
from sharetrade_tpu.distrib.pool import ActorPool as JaxActorPool
from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.distrib import ladder
from sharetrade_tpu_torch.distrib.actor import (
    HEARTBEAT_FILE, read_heartbeat, write_heartbeat)
from sharetrade_tpu_torch.distrib.pool import ActorPool, read_status


def _sleeper(actor_id, workdir):
    return subprocess.Popen(
        [sys.executable, "-c", "import time; time.sleep(120)"])


def _crasher(actor_id, workdir):
    return subprocess.Popen([sys.executable, "-c", "raise SystemExit(3)"])


def _cfg(tmp_path, cls=FrameworkConfig, **distrib):
    cfg = cls()
    cfg.distrib.actor_dir = str(tmp_path / "actors")
    # The supervise thread never races a test's poll_once().
    cfg.distrib.supervise_interval_s = 300.0
    cfg.distrib.actor_backoff_jitter = 0.0
    for key, value in distrib.items():
        setattr(cfg.distrib, key, value)
    return cfg


class _Registry:
    def __init__(self):
        self.gauges, self.counters = {}, {}

    def record(self, name, value):
        self.gauges[name] = value

    def inc(self, name, value=1.0):
        self.counters[name] = self.counters.get(name, 0.0) + value


@pytest.fixture
def pools():
    made = []

    def make(tmp_path, spawn_fn, n=1, *, registry=None, **distrib):
        pool = ActorPool(_cfg(tmp_path, **distrib), registry=registry,
                         spawn_fn=spawn_fn).start(n)
        made.append(pool)
        return pool

    yield make
    for pool in made:
        pool.stop(grace_s=5.0)


def wait_exit(pool, ids=None):
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        if all(h.proc is None or h.proc.poll() is not None
               for aid, h in pool._actors.items()
               if ids is None or aid in ids):
            return
        time.sleep(0.01)
    raise AssertionError("stub children did not exit in time")


def stamp(pool, handle, phase="rolling", age_s=0.0):
    path = os.path.join(pool.dir, handle.actor_id, HEARTBEAT_FILE)
    write_heartbeat(path, pid=handle.pid, actor_id=handle.actor_id,
                    env_steps=8, episodes=0, chunks=1, rows=8,
                    params_step=0, phase=phase)
    if age_s:
        hb = read_heartbeat(path)
        hb["time"] = time.time() - age_s
        with open(path, "w") as f:
            json.dump(hb, f)


# ---------------------------------------------------------------------------
# the ladder
# ---------------------------------------------------------------------------

def test_negative_restart_budget_rejected(tmp_path):
    with pytest.raises(ConfigError):
        ActorPool(_cfg(tmp_path, max_actor_restarts=-1), spawn_fn=_sleeper)


def test_crash_backs_off_then_respawns_with_a_growing_streak(tmp_path, pools):
    pool = pools(tmp_path / "slow", _crasher, actor_backoff_initial_s=30.0,
                 max_actor_restarts=5)
    wait_exit(pool)
    pool.poll_once()
    (h,) = pool._actors.values()
    assert (h.state, h.last_rc, pool.restarts_total) == ("backoff", 3, 1)
    assert h.respawn_at > time.monotonic()   # 30 s out, not yet due
    pid = h.pid
    pool.poll_once()
    assert h.state == "backoff" and h.pid == pid
    fast = pools(tmp_path / "fast", _crasher, actor_backoff_initial_s=0.0,
                 max_actor_restarts=10)
    (h,) = fast._actors.values()
    for _ in range(4):
        wait_exit(fast)
        fast.poll_once()                     # reap -> backoff
        fast.poll_once()                     # 0 s backoff: respawned
        assert h.state == "starting"
    assert [h.restarts, h.streak] == [4, 4]


def test_terminal_failure_degrades_onto_survivors(tmp_path, pools):
    registry = _Registry()
    pool = pools(tmp_path, _crasher, actor_backoff_initial_s=0.0,
                 max_actor_restarts=2, registry=registry)
    (h,) = pool._actors.values()
    for _ in range(12):
        if h.state == "failed":
            break
        wait_exit(pool)
        pool.poll_once()
    assert h.state == "failed" and h.streak == 3
    assert pool.counts()["failed"] == 1
    pid = h.pid
    pool.poll_once()                         # a corpse never respawns
    assert h.state == "failed" and h.pid == pid
    assert registry.counters["actor_restarts_total"] == 3.0
    assert registry.gauges["actors_failed"] == 1.0


def test_rolling_heartbeat_resets_the_streak(tmp_path, pools):
    pool = pools(tmp_path, _crasher, actor_backoff_initial_s=0.0,
                 max_actor_restarts=5)
    (h,) = pool._actors.values()
    wait_exit(pool)
    pool.poll_once()
    pool.poll_once()
    assert h.streak == 1 and h.state == "starting"
    pool._spawn_fn = _sleeper
    wait_exit(pool)
    pool.poll_once()
    pool.poll_once()                         # respawned as a sleeper
    assert h.streak == 2
    stamp(pool, h)
    pool.poll_once()
    assert h.state == "alive" and h.streak == 0


def test_a_dead_incarnations_heartbeat_is_ignored(tmp_path, pools):
    pool = pools(tmp_path, _sleeper, actor_backoff_initial_s=0.0)
    (h,) = pool._actors.values()
    stamp(pool, h)
    hb_path = os.path.join(pool.dir, h.actor_id, HEARTBEAT_FILE)
    h.proc.kill()
    wait_exit(pool)
    pool.poll_once()                         # crash -> backoff
    pool.poll_once()                         # respawn wipes the stamp
    assert read_heartbeat(hb_path) is None
    pool.poll_once()
    assert h.state == "starting"


@pytest.mark.parametrize("seed", [0, 7])
def test_backoff_schedule_equals_the_jax_pool(tmp_path, seed):
    kw = dict(max_actor_restarts=6, actor_backoff_initial_s=0.2,
              actor_backoff_max_s=3.0, actor_backoff_jitter=0.3)
    port = ActorPool(_cfg(tmp_path / "p", **kw), spawn_fn=_sleeper)
    ref = JaxActorPool(_cfg(tmp_path / "j", JaxConfig, **kw),
                       spawn_fn=_sleeper)
    port._rng, ref._rng = random.Random(seed), random.Random(seed)

    def policy(mod, dc):
        return mod.LadderPolicy(
            max_restarts=dc.max_actor_restarts,
            backoff_initial_s=dc.actor_backoff_initial_s,
            backoff_max_s=dc.actor_backoff_max_s,
            backoff_jitter=dc.actor_backoff_jitter)

    got = [ladder.crash_step(s, policy(ladder, port.cfg.distrib), port._rng)
           for s in range(1, 9)]
    want = [jladder.crash_step(s, policy(jladder, ref.cfg.distrib),
                               ref._rng) for s in range(1, 9)]
    assert got == want and got[-1] == (ladder.FAILED, 0.0)
    # The pools seed their rngs alike from the run's seed.
    assert (ActorPool(_cfg(tmp_path / "p2"), spawn_fn=_sleeper)._rng.random()
            == JaxActorPool(_cfg(tmp_path / "j2", JaxConfig),
                            spawn_fn=_sleeper)._rng.random())


# ---------------------------------------------------------------------------
# membership
# ---------------------------------------------------------------------------

def test_scale_up_and_down(tmp_path, pools):
    pool = pools(tmp_path, _sleeper, 2)
    pool.scale(3)
    assert pool.counts()["alive"] == 3
    pool.scale(1)
    retiring = [a for a, h in pool._actors.items() if h.state == "retiring"]
    assert retiring == ["a1", "a2"]          # the newest retire first
    wait_exit(pool, retiring)
    pool.poll_once()
    counts = pool.counts()
    assert counts["alive"] == 1 and counts["retired"] == 2
    assert pool.restarts_total == 0          # retiring exits are no crash


@pytest.mark.parametrize("written,target,events", [
    ("3\n", 3, 1), ("-3", 1, 0), ("two", 1, 0)])
def test_the_scale_file_drives_the_live_pool(tmp_path, pools, written,
                                             target, events):
    pool = pools(tmp_path, _sleeper)
    (tmp_path / "actors" / "scale").write_text(written)
    pool.poll_once()
    assert pool.target == target and pool.scale_events == events
    assert pool.counts()["alive"] == target


def test_a_lingering_scale_file_does_not_undo_an_api_scale(tmp_path, pools):
    pool = pools(tmp_path, _sleeper)
    (tmp_path / "actors" / "scale").write_text("2")
    pool.poll_once()
    assert pool.target == 2
    pool.scale(4)
    pool.poll_once()                         # the file still says 2
    assert pool.target == 4 and pool.counts()["alive"] == 4


def test_a_failed_actor_is_not_counted_toward_the_target(tmp_path, pools):
    pool = pools(tmp_path, _crasher, actor_backoff_initial_s=0.0,
                 max_actor_restarts=0)
    wait_exit(pool)
    pool.poll_once()
    assert pool.counts()["failed"] == 1
    pool._spawn_fn = _sleeper
    pool.scale(1)
    counts = pool.counts()
    assert counts["alive"] == 1 and counts["failed"] == 1
    assert sorted(pool._actors) == ["a0", "a1"]


def test_quiesce_retires_exits_and_refuses_scale(tmp_path, pools):
    pool = pools(tmp_path, _sleeper, 2)
    pool.quiesce()
    pool.scale(3)
    assert len(pool._actors) == 2 and pool.scale_events == 0
    for h in pool._actors.values():
        h.proc.kill()
    wait_exit(pool)
    pool.poll_once()
    assert pool.counts()["retired"] == 2 and pool.restarts_total == 0


def test_kill_all_leaves_no_live_children(tmp_path, pools):
    pool = pools(tmp_path, _sleeper, 3)
    pids = [h.pid for h in pool._actors.values()]
    pool.kill_all()
    wait_exit(pool)
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    pool.poll_once()
    assert pool.restarts_total == 0


# ---------------------------------------------------------------------------
# heartbeat timeout and status
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("phase", ["rolling", "starting"])
def test_a_stale_heartbeat_kills_into_the_ladder(tmp_path, pools, phase):
    pool = pools(tmp_path, _sleeper, heartbeat_timeout_s=5.0,
                 actor_backoff_initial_s=30.0)
    (h,) = pool._actors.values()
    if phase == "rolling":
        stamp(pool, h)
        pool.poll_once()
        assert h.state == "alive"
    stamp(pool, h, phase=phase, age_s=60.0)
    pool.poll_once()                         # presumed wedged: killed
    wait_exit(pool)
    pool.poll_once()                         # reaped as a crash
    assert h.state == "backoff" and pool.restarts_total == 1


def test_timeout_zero_only_observes(tmp_path, pools):
    pool = pools(tmp_path, _sleeper, heartbeat_timeout_s=0.0)
    (h,) = pool._actors.values()
    stamp(pool, h, age_s=3600.0)
    pool.poll_once()
    assert h.proc.poll() is None and h.heartbeat_age_s > 3000


def test_status_json_names_every_member(tmp_path, pools):
    registry = _Registry()
    pool = pools(tmp_path, _sleeper, 2, registry=registry)
    stamp(pool, pool._actors["a0"])
    pool.poll_once()
    status = read_status(pool.dir)
    assert status["pid"] == os.getpid() and status["target"] == 2
    assert sorted(status["actors"]) == ["a0", "a1"]
    assert status["actors"]["a0"]["state"] == "alive"
    assert status["actors"]["a0"]["rows"] == 8
    assert status["actors"]["a1"]["state"] == "starting"
    assert registry.gauges["actors_alive"] == 2.0
    assert registry.gauges["actors_failed"] == 0.0
    assert "actor_heartbeat_age_s_a0" in registry.gauges
    assert read_status(str(tmp_path / "nowhere")) is None
    (tmp_path / "actors" / "status.json").write_text('{"pid": 12')
    assert read_status(pool.dir) is None     # torn


def test_the_pool_spawns_the_ports_cli_actor_on_its_device(tmp_path,
                                                           monkeypatch):
    seen = []

    class _Proc:
        pid = 4242

        def poll(self):
            return None

    monkeypatch.setattr(subprocess, "Popen",
                        lambda cmd, **kw: seen.append(cmd) or _Proc())
    pool = ActorPool(_cfg(tmp_path), device="cpu", symbol="MSFT")
    with pool._lock:
        pool._spawn_new_locked()
    cmd = seen[0]
    assert cmd[:4] == [sys.executable, "-m", "sharetrade_tpu_torch.cli",
                       "actor"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[cmd.index("--actor-id") + 1] == "a0"
    saved = json.loads((tmp_path / "actors" / "actor_config.json")
                       .read_text())
    assert saved["distrib"]["actor_dir"] == str(tmp_path / "actors")
    assert pool.journal_paths() == {
        "a0": str(tmp_path / "actors" / "a0" / "transitions.journal")}
