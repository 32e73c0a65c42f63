"""The port's event journal (``sharetrade_tpu_torch/data/journal.py``)
against the JAX package's, on the CPU.

- The same events, appended through either package's ``Journal``, give
  byte-identical files, and each package replays the other's file to the
  same events (JSON events and packed binary payloads both).
- Torn tails: a cut record and a garbage header are truncated at open, in
  both packages to the same bytes, and appends continue from there.
- Group commit: the count watermark batches appends (nothing on disk until
  it fills), a reader and ``close`` commit the batch, an append after close
  raises; the interval watermark commits on time.
- Segment rotation: the same appends under ``segment_records`` give the
  same sealed segments (names and bytes) in both packages, replay in
  append order, and a reopen continues the numbering; ``compact`` removes
  the segments.
- The writer lock: a JAX ``Journal`` holding a path in another process
  makes the port's open raise ``JournalLockError``, and the reverse; in one
  process the holds are refcounted.

Every journal sits under ``tmp_path``; a test closes one package's journal
before the other opens the same path (the two lock tables are separate).
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from sharetrade_tpu.data import journal as jjournal
from sharetrade_tpu_torch.data import journal as tjournal

PACKAGES = {"jax": jjournal, "torch": tjournal}

EVENTS = [{"type": "prices_fetched", "symbol": "MSFT",
           "series": {"symbol": "MSFT", "dates": ["1992-07-22"],
                      "prices": [2.09375]}},
          {"n": 1, "x": 0.1, "s": "é", "nested": {"b": [1, 2.5, None]}},
          {"type": "checkpoint", "updates": 400, "ok": True}]


def _payload(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    return b"STR1" + rng.integers(0, 255, 37, dtype=np.uint8).tobytes()


def _write(mod, path, **kw):
    with mod.Journal(str(path), **kw) as j:
        for e in EVENTS:
            j.append(e)
        j.append_bytes(_payload(0))
        j.append({"after": "binary"})


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_files_are_byte_identical_and_replay_across(tmp_path, writer,
                                                    reader):
    paths = {name: tmp_path / f"{name}.journal" for name in PACKAGES}
    for name, mod in PACKAGES.items():
        _write(mod, paths[name])
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()
    with PACKAGES[reader].Journal(str(paths[writer])) as j:
        # Binary STR1 payloads are skipped by replay in both packages.
        assert list(j.replay()) == EVENTS + [{"after": "binary"}]
        assert len(j) == len(EVENTS) + 1
    frames = [p for _, p in tjournal.iter_framed_records(str(paths[writer]))]
    assert frames == [p for _, p in
                      jjournal.iter_framed_records(str(paths[writer]))]
    assert frames[len(EVENTS)] == _payload(0)
    assert tjournal.frame_record(b"abc") == jjournal.frame_record(b"abc")


@pytest.mark.parametrize("damage", ["cut", "garbage_header"])
def test_torn_tail_truncates_like_the_reference(tmp_path, damage):
    for name, mod in PACKAGES.items():
        path = tmp_path / f"{name}.journal"
        _write(mod, path)
        raw = path.read_bytes()
        if damage == "cut":
            path.write_bytes(raw[:-5])
        else:
            path.write_bytes(raw + b"\xf0\xff\xff\xff\x00\x00")
        with mod.Journal(str(path)) as j:
            events = list(j.replay())
            j.append({"resumed": True})
        want = EVENTS if damage == "cut" else EVENTS + [{"after": "binary"}]
        assert events == want
        with PACKAGES["torch" if name == "jax" else "jax"].Journal(
                str(path)) as j:
            assert list(j.replay()) == want + [{"resumed": True}]
    # The same prefix kept, then the same record.
    assert (tmp_path / "jax.journal").read_bytes() == \
        (tmp_path / "torch.journal").read_bytes()


def test_group_commit_watermarks(tmp_path):
    path = str(tmp_path / "g.journal")
    j = tjournal.Journal(path, fsync_every_records=3)
    j.append({"n": 0})
    j.append({"n": 1})
    assert os.path.getsize(path) == 0          # batched, not on disk yet
    j.append({"n": 2})                         # the watermark commits
    committed = os.path.getsize(path)
    assert committed > 0
    j.append({"n": 3})
    assert os.path.getsize(path) == committed
    assert [e["n"] for e in j.replay()] == [0, 1, 2, 3]   # readers flush
    j.append({"n": 4})
    j.close()                                  # close commits the batch
    with jjournal.Journal(path) as jj:
        assert [e["n"] for e in jj.replay()] == [0, 1, 2, 3, 4]
    with pytest.raises(ValueError):
        j.append({"n": 5})
    timed = tjournal.Journal(str(tmp_path / "t.journal"),
                             fsync_every_records=0, fsync_interval_s=0.05)
    timed.append({"n": 0})
    assert os.path.getsize(timed.path) == 0
    time.sleep(0.06)
    timed.append({"n": 1})                     # arrives past the interval
    assert os.path.getsize(timed.path) > 0
    timed.close()


def test_segment_rotation_matches_the_reference(tmp_path):
    dirs = {}
    for name, mod in PACKAGES.items():
        d = tmp_path / name
        path = str(d / "seg.journal")
        with mod.Journal(path, segment_records=3) as j:
            for n in range(10):
                j.append({"n": n})
        dirs[name] = d
        assert [os.path.basename(p) for p in mod.segment_paths(path)] == [
            f"seg.journal.seg{i:08d}" for i in (1, 2, 3)]
    for seg in sorted(os.listdir(dirs["jax"])):
        if seg.endswith(".lock"):
            continue
        assert (dirs["jax"] / seg).read_bytes() == \
            (dirs["torch"] / seg).read_bytes(), seg
    path = str(dirs["jax"] / "seg.journal")
    with tjournal.Journal(path, segment_records=3) as j:   # port reopens
        assert [e["n"] for e in j.replay()] == list(range(10))
        for n in range(10, 13):
            j.append({"n": n})
        assert len(tjournal.segment_paths(path)) == 4
        j.compact([{"n": "snapshot"}])
        assert tjournal.segment_paths(path) == []
    with jjournal.Journal(path) as j:
        assert list(j.replay()) == [{"n": "snapshot"}]


_HOLD = """
import sys
from {pkg}.data.journal import Journal
j = Journal(sys.argv[1])
print("held", flush=True)
sys.stdin.read()
j.close()
"""


@pytest.mark.parametrize("holder,opener", [("jax", "torch"),
                                           ("torch", "jax")])
def test_a_live_writer_in_another_process_is_refused(tmp_path, holder,
                                                     opener):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = "sharetrade_tpu" if holder == "jax" else "sharetrade_tpu_torch"
    path = str(tmp_path / "locked.journal")
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", _HOLD.format(pkg=pkg),
                             path], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, env=env)
    try:
        assert proc.stdout.readline().strip() == "held"
        mod = PACKAGES[opener]
        with pytest.raises(mod.JournalLockError, match=str(proc.pid)):
            mod.Journal(path)
    finally:
        proc.communicate("", timeout=60)
    # The holder's exit released the lock: the opener now writes.
    with PACKAGES[opener].Journal(path) as j:
        j.append({"after": holder})


def test_in_process_holds_are_refcounted(tmp_path):
    path = str(tmp_path / "r.journal")
    a = tjournal.Journal(path)
    b = tjournal.Journal(path)            # same process: legal
    a.close()
    lock = os.path.realpath(path) + ".lock"
    assert lock in tjournal._HELD_LOCKS    # b still holds it
    b.close()
    assert lock not in tjournal._HELD_LOCKS
    tjournal.release_writer_lock(path)    # unheld: a no-op
