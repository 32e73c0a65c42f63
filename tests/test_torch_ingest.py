"""The learner's actor-feed ingest (``Orchestrator.ingest_actor_feeds``)
in the port against the JAX orchestrator's, on the CPU.

Size: 72 prices (horizon 64), window 8, hidden 8, 4 agents, 12-step
chunks, replay capacity 64 and minibatch 8 (the ingest wraps the circular
buffer).

- Journals written by both packages' codecs (``append_transitions``
  through each package's ``Journal``), one with the wrong observation
  width, ingested tick by tick by both orchestrators with
  ``distrib.ingest_max_rows=20`` (full windows: the backlog streams across
  ticks), uniform replay and PER: after every tick the rows ingested, the
  cursors, the replay's contents, write position and size are the JAX
  orchestrator's exactly, and the PER sum-tree's levels and max priority
  within 1e-6; the mis-sized journal is refused with its cursor advanced;
  a journal that grows between ticks is read from its cursor on.
- The ingest reader (``data/transitions.read_new_transitions``, a walk of
  the headers that reads only the payloads it keeps) against the JAX
  reader over a segmented journal, across floors and caps: clean, with a
  torn tail, and with a corrupt payload above the floor (its file ends
  there in both); it reads no payload at or below the floor or past the
  cap, and names each kept record's stamp and rows. Each tick's
  ``actor_feed_ingest`` event (``cli learner --events``) carries per actor
  the cursor it read from, the one it left, the rows and the first record
  read, and the ticks chain.
- The adaptive cadence (``tuning.adaptive_ingest``) over one trace of
  (rows, backlog) ticks: dry backoff, backlog tightening down to base/4,
  the snap back to base, in the JAX orchestrator's sequence step for step.
- ``cli train`` with feeds and no pool (``distrib.num_actors=1``, the
  journals pre-written): a whole episode through each orchestrator, the
  synchronous loop and the async pipeline (the boundary rows flag the
  ingest cadence, the dispatcher drains and ingests): the same rows
  ingested per writer, the same cursors and counters as the JAX run's; and
  ``distrib.num_actors`` is no longer refused.
- ``tools/torch_autotune.py``'s ``distrib`` spec, quick, on the CPU (6-chunk
  episodes): every arm ingests the feeder's rows, and the best arm names
  both knobs.
"""

import json
import os
import sys

import numpy as np
import pytest

from sharetrade_tpu.config import FrameworkConfig as JaxConfig
from sharetrade_tpu.data.journal import Journal as JaxJournal
from sharetrade_tpu.data.transitions import (
    append_transitions as jax_append)
from sharetrade_tpu.data.transitions import (
    read_new_transitions as jax_read_new)
from sharetrade_tpu.runtime import Orchestrator as JaxOrchestrator
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.data.journal import Journal
from sharetrade_tpu_torch.data import transitions as ttr
from sharetrade_tpu_torch.data.journal import segment_paths
from sharetrade_tpu_torch.data.transitions import append_transitions
from sharetrade_tpu_torch.utils.logging import EventLog
from sharetrade_tpu_torch.runtime import Orchestrator
from sharetrade_tpu_torch.runtime.orchestrator import check_ported

WINDOW, OBS = 8, 10
PRICES = np.linspace(10.0, 20.0, 72, dtype=np.float32)


def _cfg(cls, tmp_path, tag, *extra):
    return cls().apply_overrides([
        "learner.algo=dqn", f"env.window={WINDOW}", "model.hidden_dim=8",
        "parallel.num_workers=4", "runtime.chunk_steps=12",
        "learner.replay_capacity=64", "learner.replay_batch=8",
        f"distrib.actor_dir={tmp_path / 'actors'}",
        f"runtime.checkpoint_dir={tmp_path / ('ckpt_' + tag)}",
        f"data.journal_dir={tmp_path / ('journal_' + tag)}", *extra])


def _write(root, writer, records, *, jax_codec, seed, obs_dim=OBS,
           stamp0=0, segment_records=0):
    """``records`` packed records of 3-9 rows, stamps increasing; returns
    the journal path."""
    rng = np.random.default_rng(seed)
    path = str(root / writer / "transitions.journal")
    journal = (JaxJournal if jax_codec else Journal)(
        path, segment_records=segment_records)
    append = jax_append if jax_codec else append_transitions
    stamp = stamp0
    for _ in range(records):
        n = int(rng.integers(3, 10))
        stamp += int(rng.integers(1, 5))
        append(journal, rng.normal(size=(n, obs_dim)).astype(np.float32),
               rng.integers(0, 3, n).astype(np.int32),
               rng.normal(size=n).astype(np.float32),
               rng.normal(size=(n, obs_dim)).astype(np.float32),
               env_steps=stamp)
    journal.close()
    return path


def _pair(tmp_path, *extra):
    jorch = JaxOrchestrator(_cfg(JaxConfig, tmp_path, "j", *extra))
    torch_orch = Orchestrator(_cfg(FrameworkConfig, tmp_path, "t", *extra),
                              device="cpu")
    jorch.send_training_data(PRICES)
    torch_orch.send_training_data(PRICES)
    return jorch, torch_orch


def _assert_same_extras(jorch, torch_orch):
    j, t = jorch._ts.extras, torch_orch._ts.extras
    for name in ("obs", "action", "reward", "next_obs", "pos", "size"):
        np.testing.assert_array_equal(getattr(t.replay, name).numpy(),
                                      np.asarray(getattr(j.replay, name)),
                                      err_msg=name)
    assert (t.per is None) == (getattr(j, "per", None) is None)
    if t.per is not None:
        for a, b in zip(t.per.tree.levels, j.per.tree.levels):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        np.testing.assert_allclose(float(t.per.max_priority),
                                   float(j.per.max_priority), rtol=1e-6)


@pytest.mark.parametrize("priority", ["uniform", "per"])
def test_ingest_ticks_match_the_jax_orchestrator(tmp_path, priority):
    root = tmp_path / "actors"
    _write(root, "a0", 8, jax_codec=True, seed=1)
    _write(root, "a1", 6, jax_codec=False, seed=2)
    _write(root, "bad", 2, jax_codec=False, seed=3, obs_dim=OBS + 1)
    jorch, torch_orch = _pair(
        tmp_path, "distrib.ingest_without_pool=true",
        "distrib.ingest_max_rows=20",
        f"learner.replay_priority={priority}")
    totals = []
    for tick in range(6):
        if tick == 3:           # a0 grows between ticks (the port's codec)
            _write(root, "a0", 3, jax_codec=False, seed=4,
                   stamp0=jorch._actor_cursors["a0"] + 100)
        got, want = torch_orch.ingest_actor_feeds(), jorch.ingest_actor_feeds()
        assert got == want
        totals.append(got)
        assert torch_orch._actor_cursors == jorch._actor_cursors
        _assert_same_extras(jorch, torch_orch)
    assert totals[0] > 0 and totals[-1] == 0         # drained the backlog
    assert int(torch_orch._ts.extras.replay.size) == 64      # wrapped
    counters = torch_orch.metrics.counters()
    assert counters["distrib_rows_ingested_total"] == sum(totals)
    assert "actor_rows_ingested_total_bad" not in counters
    assert torch_orch._actor_cursors["bad"] > 0      # refused, moved past
    feeds = torch_orch.actor_feeds
    assert feeds["a0"]["rows"] + feeds["a1"]["rows"] == sum(totals)
    assert feeds["bad"]["rows"] == 0


def _damage(path, fault):
    """A torn tail (the last record cut short), or one flipped payload
    byte in the second-to-last record."""
    heads = ttr.record_heads(path)
    if fault == "torn":
        with open(path, "r+b") as f:
            f.truncate(heads[-1].offset + heads[-1].length // 2)
    elif fault == "corrupt":
        with open(path, "r+b") as f:
            f.seek(heads[-2].offset + heads[-2].length - 3)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))


@pytest.mark.parametrize("fault", ["clean", "torn", "corrupt"])
def test_ingest_reader_matches_the_jax_reader(tmp_path, monkeypatch, fault):
    path = _write(tmp_path, "a0", 14, jax_codec=False, seed=7,
                  segment_records=4)
    assert len(segment_paths(path)) == 3
    _damage(path, fault)
    stamps = ttr.transition_stamps(path)
    read = []
    real = ttr._read_payload
    monkeypatch.setattr(ttr, "_read_payload",
                        lambda p, head: read.append(head) or real(p, head))
    for floor in (0, stamps[3][0], stamps[9][0], stamps[-1][0]):
        for cap in (0, 1, 20, 1000):
            read.clear()
            records = []
            got = ttr.read_new_transitions(path, floor, cap, records=records)
            want = jax_read_new(path, floor, cap)
            for a, b in zip(got[:4], want[:4]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            # The cursor each leaves (a record at or below the floor is not
            # re-checked, so only the full walk stops at a corrupt one).
            assert max(floor, got[4]) == max(floor, want[4])
            assert sum(r for _, r in records) == len(got[0])
            assert all(s > floor for s, _ in records)
            assert set(records) <= {(h.env_steps, h.batch) for h in read}
            # Only what the tick keeps is read: above the floor, within
            # the cap (a corrupt payload is read once, then left out).
            assert all(h.env_steps > floor for h in read)
            assert len(read) <= len(records) + (fault == "corrupt")
            if records:
                assert got[4] == records[-1][0]


def test_ingest_events_carry_each_ticks_cursors(tmp_path):
    root = tmp_path / "actors"
    _write(root, "a0", 8, jax_codec=False, seed=1)
    _write(root, "a1", 6, jax_codec=False, seed=2)
    cfg = _cfg(FrameworkConfig, tmp_path, "t",
               "distrib.ingest_without_pool=true",
               "distrib.ingest_max_rows=20")
    events_path = tmp_path / "events.jsonl"
    events = EventLog(str(events_path))
    orch = Orchestrator(cfg, device="cpu", event_log=events)
    orch.send_training_data(PRICES)
    while orch.ingest_actor_feeds():
        pass
    events.close()
    ticks = [json.loads(line) for line in events_path.read_text().splitlines()
             if json.loads(line)["kind"] == "actor_feed_ingest"]
    assert len(ticks) > 2
    for aid in ("a0", "a1"):
        stamps = ttr.transition_stamps(str(root / aid /
                                           "transitions.journal"))
        mine = [t["feeds"][aid] for t in ticks if aid in t["feeds"]]
        assert mine[0]["cursor"] == 0
        for prev, cur in zip(mine, mine[1:]):
            assert cur["cursor"] == prev["high_water"]
        read = [s for s in stamps if any(
            f["cursor"] < s[0] <= f["high_water"] for f in mine)]
        assert read == stamps                       # every record, once
        assert sum(f["rows"] for f in mine) == \
            orch.actor_feeds[aid]["rows"] == sum(r for _, r in stamps)
        assert [f["first"] for f in mine] == [list(s) for s in stamps if any(
            s[0] == min(x for x, _ in stamps if x > f["cursor"])
            for f in mine)]
        assert mine[-1]["high_water"] == stamps[-1][0]
    orch.stop()


def test_adaptive_cadence_steps_as_the_jax_one(tmp_path):
    jorch, torch_orch = _pair(tmp_path, "distrib.ingest_without_pool=true",
                              "distrib.ingest_every_updates=8")
    trace = ([(0, False)] * 7 + [(5, False)] + [(20, True)] * 4
             + [(3, False)] + [(0, False)] * 4 + [(9, True), (2, False)])
    seq = []
    for rows, backlog in trace:
        torch_orch._adapt_ingest_cadence(rows, backlog)
        jorch._adapt_ingest_cadence(rows, backlog)
        assert torch_orch._ingest_every == jorch._ingest_every
        seq.append(torch_orch._ingest_every)
    assert max(seq) == 64 and min(seq) == 2          # 8 x base, base / 4
    assert torch_orch.metrics.counters()["ingest_adjustments_total"] == \
        sum(a != b for a, b in zip([8] + seq, seq))


@pytest.mark.parametrize("async_on", [False, True], ids=["sync", "async"])
def test_train_ingests_feeds_without_a_pool_as_jax_does(tmp_path, async_on):
    assert check_ported(FrameworkConfig().apply_overrides(
        ["distrib.num_actors=2"])) is None
    root = tmp_path / "actors"
    _write(root, "a0", 12, jax_codec=True, seed=5)
    _write(root, "a1", 12, jax_codec=False, seed=6)
    extra = ("distrib.num_actors=1", "distrib.ingest_every_updates=16",
             "distrib.ingest_max_rows=25", "runtime.metrics_every_chunks=1",
             f"runtime.async_pipeline={str(async_on).lower()}")
    jorch, torch_orch = _pair(tmp_path, *extra)
    for orch in (jorch, torch_orch):
        orch.start_training(background=False)
        assert orch.is_everything_done().state.value == "Completed"
    assert torch_orch._actor_cursors == jorch._actor_cursors
    got = torch_orch.metrics.counters()
    want = jorch.metrics.counters()
    for key in ("distrib_rows_ingested_total", "actor_rows_ingested_total_a0",
                "actor_rows_ingested_total_a1"):
        assert got[key] == want[key] > 0, key
    assert torch_orch._ingest_every == jorch._ingest_every
    torch_orch.stop()


def test_autotune_distrib_spec_on_the_cpu(tmp_path, monkeypatch):
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    try:
        import torch_autotune
    finally:
        sys.path.pop(0)
    # Episodes of 6 chunks (the tool's 24 at this size take seconds each).
    monkeypatch.setattr(torch_autotune.DistribMeasurer, "CHUNKS", 6)
    out = torch_autotune.run_spec("distrib", quick=True, seed=0,
                                  workdir=str(tmp_path), exhaustive=False,
                                  device="cpu", log_fn=lambda msg: None)
    assert out["arms"] == 2 and set(out["best"]) == {
        "distrib.ingest_every_updates", "distrib.ingest_max_rows"}
    assert all(t["rows_ingested_per_sec"] > 0 and t["rows_fed"] > 0
               for t in out["trials"])
