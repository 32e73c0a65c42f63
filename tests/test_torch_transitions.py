"""The port's packed transition codec and its readers
(``sharetrade_tpu_torch/data/transitions.py``) against the JAX package's,
on the CPU.

- ``encode_transitions`` gives the JAX bytes for the same arrays (seeded
  numpy), ``decode_transitions`` and ``peek_transitions_header`` invert
  them, and a malformed payload is refused by both.
- A journal written by either package (records of 3-7 rows stamped with
  increasing env steps, a JSON event among them) is the same file, and on
  both packages' files the two packages' ``read_tail_transitions`` (with
  and without a cutoff, a cutoff that excludes everything, a live journal
  quiesced through ``journal=``), ``read_new_transitions`` (a floor, a row
  cap) and ``count_transition_rows`` return the same arrays and stamps.
- ``compact_transitions`` keeps the same tail and leaves the same bytes;
  on a segmented journal ``retire_transition_segments`` retires the same
  segments, frees the same bytes, and the tail reads the same after.
"""

import os
import shutil

import numpy as np
import pytest

from sharetrade_tpu.data import journal as jjournal
from sharetrade_tpu.data import transitions as jtr
from sharetrade_tpu_torch.data import journal as tjournal
from sharetrade_tpu_torch.data import transitions as ttr

PACKAGES = {"jax": (jjournal, jtr), "torch": (tjournal, ttr)}
OBS_DIM = 6


def _batch(rng, rows):
    return (rng.standard_normal((rows, OBS_DIM)).astype(np.float32),
            rng.integers(0, 3, rows).astype(np.int64),
            rng.standard_normal(rows).astype(np.float32),
            rng.standard_normal((rows, OBS_DIM)).astype(np.float32))


def _records(seed=0, n=9):
    rng = np.random.default_rng(seed)
    return [(_batch(rng, int(rng.integers(3, 8))), 10 * (i + 1))
            for i in range(n)]


def _write(name, path, records, **kw):
    jmod, tmod = PACKAGES[name]
    with jmod.Journal(str(path), **kw) as j:
        for i, (arrays, stamp) in enumerate(records):
            tmod.append_transitions(j, *arrays, env_steps=stamp)
            if i == 2:
                j.append({"type": "note", "at": stamp})


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for x, y in zip(a[:4], b[:4]):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    assert a[4] == b[4]


def test_codec_bytes_equal_the_reference():
    rng = np.random.default_rng(1)
    arrays = _batch(rng, 5)
    payload = ttr.encode_transitions(*arrays, env_steps=1234)
    assert payload == jtr.encode_transitions(*arrays, env_steps=1234)
    obs, action, reward, next_obs, stamp = ttr.decode_transitions(payload)
    np.testing.assert_array_equal(obs, arrays[0])
    np.testing.assert_array_equal(action, arrays[1].astype(np.int32))
    np.testing.assert_array_equal(next_obs, arrays[3])
    assert stamp == 1234 and action.dtype == np.int32
    assert ttr.peek_transitions_header(payload) == (5, OBS_DIM, 1234)
    for bad in (payload[:-1], b"STR0" + payload[4:], b"{}"):
        assert ttr.decode_transitions(bad) is None
        assert jtr.decode_transitions(bad) is None
        assert ttr.peek_transitions_header(bad) is None
    with pytest.raises(ValueError):
        ttr.encode_transitions(arrays[0], arrays[1][:4], arrays[2],
                               arrays[3])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_readers_agree_on_both_packages_files(tmp_path, writer):
    records = _records()
    paths = {}
    for name in PACKAGES:
        paths[name] = tmp_path / f"{name}.journal"
        _write(name, paths[name], records)
    assert paths["jax"].read_bytes() == paths["torch"].read_bytes()
    path = str(paths[writer])
    total = sum(len(r[0][1]) for r in records)
    assert ttr.count_transition_rows(path) == jtr.count_transition_rows(
        path) == total
    for max_rows, cutoff in ((0, 0), (12, 0), (12, 50), (1000, 35),
                             (5, 5)):
        got = ttr.read_tail_transitions(path, max_rows,
                                        cutoff_env_steps=cutoff)
        _same(got, jtr.read_tail_transitions(path, max_rows,
                                             cutoff_env_steps=cutoff))
        assert got[4] == 90                   # the high water, always
    assert len(ttr.read_tail_transitions(path, 5, cutoff_env_steps=5)[0]) \
        == 0                                  # every record past the cutoff
    for floor, cap in ((0, 0), (40, 0), (40, 9), (90, 0)):
        _same(ttr.read_new_transitions(path, floor, cap),
              jtr.read_new_transitions(path, floor, cap))
    assert ttr.read_tail_transitions(str(tmp_path / "none"), 8) is None


def test_live_journal_is_quiesced_before_the_tail_read(tmp_path):
    path = str(tmp_path / "live.journal")
    j = tjournal.Journal(path, fsync_every_records=64)
    arrays = _batch(np.random.default_rng(2), 4)
    ttr.append_transitions(j, *arrays, env_steps=7)
    assert ttr.read_tail_transitions(path, 8) is None    # still batched
    got = ttr.read_tail_transitions(path, 8, journal=j)
    np.testing.assert_array_equal(got[0], arrays[0])
    assert got[4] == 7
    j.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_compaction_keeps_the_same_tail(tmp_path, writer):
    records = _records(seed=3)
    src = tmp_path / "src.journal"
    _write(writer, src, records)
    out = {}
    for name, (jmod, tmod) in PACKAGES.items():
        path = tmp_path / f"{name}.journal"
        shutil.copy(src, path)
        with jmod.Journal(str(path)) as j:
            assert tmod.compact_transitions(j, 10)
            assert not tmod.compact_transitions(j, 10**6)
        out[name] = path.read_bytes()
    assert out["jax"] == out["torch"]
    path = str(tmp_path / "torch.journal")
    kept = ttr.read_tail_transitions(path, 0)
    assert 10 <= len(kept[0]) < 10 + 8 and kept[4] == 90


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_segment_retirement_agrees(tmp_path, writer):
    records = _records(seed=4, n=12)
    freed = {}
    for name, (jmod, tmod) in PACKAGES.items():
        d = tmp_path / name
        d.mkdir()
        _write(writer, d / "t.journal", records, segment_records=2)
        with jmod.Journal(str(d / "t.journal"), segment_records=2) as j:
            before = len(jmod.segment_paths(j.path))
            freed[name] = tmod.retire_transition_segments(j, 15)
            assert freed[name][0] > 0 and freed[name][1] > 0
            assert len(jmod.segment_paths(j.path)) == before - freed[name][0]
            # Compaction on a segmented journal retires whole segments.
            tmod.compact_transitions(j, 15)
        freed[name] += tuple(sorted(os.listdir(d)))
    assert freed["jax"] == freed["torch"]
    _same(ttr.read_tail_transitions(str(tmp_path / "torch" / "t.journal"),
                                    15),
          jtr.read_tail_transitions(str(tmp_path / "jax" / "t.journal"), 15))
