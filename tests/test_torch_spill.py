"""The port's disk spill tier (``sharetrade_tpu_torch.serve.spill``) against
the JAX package's (``sharetrade_tpu.serve.spill``), on the CPU.

- The record discipline (tests/test_spill_tier.py:148-301, mirrored): each
  unit test drives the SAME operation sequence through both packages'
  ``SpillArena`` (parametrized by package) and expects the same outcomes:
  round trip and consume-on-take, stale stamps, the clock-less
  own-incarnation rule, foreign adoption under a matching clock, corrupt,
  torn and wrong-model records, the digest rendezvous, the byte budget,
  ``scan_usage`` and ``sweep_debris``.
- Lockstep: one seeded random sequence of puts, takes, deletes and
  corruptions through a JAX arena and a port arena over separate
  directories gives equal results op for op (payloads, steps, reasons,
  counters, files).
- Records cross: a record either package seals is taken by the other,
  bytes equal; ``record_name`` agrees.

Everything here is exact (bytes), no tolerance.
"""

import os

import numpy as np
import pytest

from sharetrade_tpu.serve import spill as jspill
from sharetrade_tpu_torch.serve import spill as tspill

PACKAGES = {"jax": jspill, "port": tspill}


def _leaves(nbytes: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.random(nbytes // 8, dtype=np.float64)]


def _sealed(root) -> list[str]:
    return sorted(f for f in os.listdir(root)
                  if f.endswith(tspill.SPILL_SUFFIX))


def _flip(path, frac: float = 0.9) -> None:
    raw = bytearray(open(path, "rb").read())
    raw[int(len(raw) * frac)] ^= 0xFF
    open(path, "wb").write(bytes(raw))


@pytest.fixture(params=sorted(PACKAGES))
def mod(request):
    return PACKAGES[request.param]


def _arena(mod, root, *, nbytes=64, incarnation="inc-a", max_bytes=1 << 20):
    return mod.SpillArena(str(root), max_bytes=max_bytes,
                          record_nbytes=nbytes, incarnation=incarnation)


def test_put_take_roundtrip_consumes(mod, tmp_path):
    arena = _arena(mod, tmp_path)
    leaves = _leaves(64)
    assert arena.put("s0", leaves, steps=7)
    assert arena.probe("s0")
    payload, steps, reason, foreign = arena.take("s0", expected_steps=7)
    assert (reason, foreign, steps) == ("hit", False, 7)
    assert payload == b"".join(x.tobytes() for x in leaves)
    assert not arena.probe("s0")
    assert arena.take("s0", expected_steps=7)[2] == "miss"
    assert arena.takes == 1 and arena.sessions == 0


def test_stale_stamp_consumed(mod, tmp_path):
    arena = _arena(mod, tmp_path)
    arena.put("s0", _leaves(64), steps=7)
    payload, steps, reason, _ = arena.take("s0", expected_steps=6)
    assert (payload, steps, reason) == (None, 7, "stale")
    assert not arena.probe("s0") and arena.stale == 1


def test_no_clock_accepts_own_incarnation_only(mod, tmp_path):
    writer = _arena(mod, tmp_path, incarnation="inc-a")
    writer.put("s0", _leaves(64), steps=3)
    payload, _, reason, foreign = _arena(
        mod, tmp_path, incarnation="inc-b").take("s0")
    assert (payload, reason, foreign) == (None, "stale", True)
    writer.put("s1", _leaves(64, seed=1), steps=5)
    assert writer.take("s1")[1:] == (5, "hit", False)


def test_foreign_record_with_matching_clock_adopts(mod, tmp_path):
    _arena(mod, tmp_path, incarnation="inc-a").put("s0", _leaves(64), 9)
    payload, steps, reason, foreign = _arena(
        mod, tmp_path, incarnation="inc-b").take("s0", expected_steps=9)
    assert (steps, reason, foreign) == (9, "hit", True)
    assert payload is not None


def test_corrupt_and_torn_records_consumed(mod, tmp_path):
    arena = _arena(mod, tmp_path)
    arena.put("s0", _leaves(64), steps=1)
    _flip(tmp_path / mod.record_name("s0"))
    assert arena.take("s0", expected_steps=1)[::2] == (None, "corrupt")
    assert not arena.probe("s0") and arena.corrupt == 1
    arena.put("s1", _leaves(64, seed=1), steps=1)
    path = tmp_path / mod.record_name("s1")
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 2)
    assert arena.take("s1", expected_steps=1)[2] == "corrupt"
    arena.put("s2", _leaves(64, seed=2), steps=1)
    with open(tmp_path / mod.record_name("s2"), "r+b") as f:
        f.truncate(0)
    assert arena.take("s2", expected_steps=1)[2] == "corrupt"


def test_wrong_model_footprint(mod, tmp_path):
    arena = _arena(mod, tmp_path, nbytes=64)
    assert not arena.put("s0", _leaves(32), steps=1)
    assert arena.put_refusals == 1 and not arena.probe("s0")
    arena.put("s0", _leaves(64), steps=1)
    assert _arena(mod, tmp_path, nbytes=128).take("s0", 1)[2] == "corrupt"


def test_digest_rendezvous_never_crosses_sessions(mod, tmp_path):
    arena = _arena(mod, tmp_path)
    arena.put("s0", _leaves(64), steps=1)
    os.replace(tmp_path / mod.record_name("s0"),
               tmp_path / mod.record_name("s1"))
    assert arena.take("s1", expected_steps=1)[2] == "corrupt"


def test_byte_budget_refuses(mod, tmp_path):
    arena = _arena(mod, tmp_path, max_bytes=200)
    assert arena.put("s0", _leaves(64), steps=1)
    assert not arena.put("s1", _leaves(64, seed=1), steps=1)
    assert arena.put_refusals == 1
    assert _sealed(tmp_path) == [mod.record_name("s0")]


def test_scan_usage_reanchors_counters(mod, tmp_path):
    arena = _arena(mod, tmp_path)
    arena.put("s0", _leaves(64), steps=1)
    arena.put("s1", _leaves(64, seed=1), steps=2)
    total, count = arena.scan_usage()
    assert count == 2 and total == sum(
        os.path.getsize(tmp_path / f) for f in _sealed(tmp_path))
    os.unlink(tmp_path / mod.record_name("s0"))
    assert arena.scan_usage()[1] == 1 and arena.sessions == 1


def test_sweep_debris_only_tmp(mod, tmp_path):
    arena = _arena(mod, tmp_path)
    arena.put("s0", _leaves(64), steps=1)
    (tmp_path / "abc.spill.tmp-111").write_bytes(b"torn")
    (tmp_path / "def.spill.tmp-222").write_bytes(b"torn")
    assert mod.sweep_debris(str(tmp_path), pid=111) == 1
    assert mod.sweep_debris(str(tmp_path)) == 1
    assert _sealed(tmp_path) == [mod.record_name("s0")] and arena.probe("s0")


@pytest.mark.parametrize("sid", ["s0", "s1#2", 17, ("a", 3), "ünïcode"])
def test_record_name_agrees(sid):
    assert tspill.record_name(sid) == jspill.record_name(sid)
    assert tspill.record_name(sid).endswith(tspill.SPILL_SUFFIX)


def test_lockstep_random_operations_agree(tmp_path):
    """One seeded sequence of 300 operations (puts with random stamps,
    clocked and clock-less takes, deletes, byte flips, a foreign reader)
    through both packages' arenas, each over its own directory: every
    result, every counter and the sealed files are equal."""
    rng = np.random.default_rng(11)
    arenas = {}
    for name, mod in PACKAGES.items():
        root = tmp_path / name
        arenas[name] = (mod, root,
                        _arena(mod, root, nbytes=48, max_bytes=1500),
                        _arena(mod, root, nbytes=48, incarnation="other",
                               max_bytes=1500))
    sids = [f"s{i}" for i in range(6)]
    for step in range(300):
        op = rng.choice(["put", "take", "take_clock", "foreign", "delete",
                         "flip", "probe"])
        sid = sids[rng.integers(len(sids))]
        stamp = int(rng.integers(0, 4))
        seed = int(rng.integers(1 << 30))
        outs = {}
        for name, (mod, root, arena, other) in arenas.items():
            if op == "put":
                outs[name] = arena.put(sid, _leaves(48, seed), stamp)
            elif op == "take":
                outs[name] = arena.take(sid)
            elif op == "take_clock":
                outs[name] = arena.take(sid, expected_steps=stamp)
            elif op == "foreign":
                outs[name] = other.take(sid, expected_steps=stamp)
            elif op == "delete":
                outs[name] = arena.delete(sid)
            elif op == "probe":
                outs[name] = arena.probe(sid)
            else:
                path = root / mod.record_name(sid)
                outs[name] = path.exists() and _flip(path, 0.5 + 0.4 * (
                    seed % 100) / 100)
        assert outs["jax"] == outs["port"], (step, op, sid, outs)
        counts = {name: tuple(getattr(a, k) for k in (
            "bytes", "sessions", "puts", "put_refusals", "takes", "stale",
            "corrupt")) for name, (_, _, a, _) in arenas.items()}
        assert counts["jax"] == counts["port"], (step, op)
        assert _sealed(tmp_path / "jax") == _sealed(tmp_path / "port")


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_records_cross_packages(writer, reader, tmp_path):
    """A record sealed by one package is adopted by the other: payload
    bytes and stamp equal, the reader sees it as foreign."""
    leaves = _leaves(64, seed=5)
    assert _arena(PACKAGES[writer], tmp_path,
                  incarnation="w").put("s0", leaves, steps=4)
    payload, steps, reason, foreign = _arena(
        PACKAGES[reader], tmp_path, incarnation="r").take(
            "s0", expected_steps=4)
    assert (steps, reason, foreign) == (4, "hit", True)
    assert payload == b"".join(x.tobytes() for x in leaves)
