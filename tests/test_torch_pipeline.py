"""The port's async readback pipeline held against the JAX package's.

``runtime/pipeline.py`` of the JAX package imports only the standard
library, so both classes run here side by side: the same scripted
boundary sequences go through each, and every observation must be equal
(and what the contract says it is):

- order, ``stalls`` and ``max_depth_seen`` with the consumer held on a
  gate (depth 2: two boundaries queue, the third blocks ``put`` once);
- ``drain()`` as a strict barrier, and a no-op from the consumer thread;
- a consumer fault stored and re-raised as the same type, ``processed``
  counting the faulting and the discarded boundaries, ``attention`` set;
- the attention rows, in chunk order with their heals marks and end
  indices;
- ``shutdown()`` discarding queued boundaries;
- depth 0 refused.

Each script takes well under a second.
"""

import threading
import time

import pytest

from sharetrade_tpu.runtime import pipeline as jax_pipeline
from sharetrade_tpu_torch.runtime import pipeline as torch_pipeline

MODULES = {"jax": jax_pipeline, "torch": torch_pipeline}


def _boundary(mod, base, *, k=1, mark=0):
    return mod.Boundary(base, k, {"base": base}, None, mark, k)


def _wait_for(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("timed out")
        time.sleep(0.005)


def script_blocked_consumer(mod):
    gate, started, seen = threading.Event(), threading.Event(), []

    def consume(b):
        started.set()
        gate.wait(10)
        seen.append(b.base)
        return {"env_steps": float(b.base)}

    pl = mod.AsyncPipeline(2, consume)
    assert pl.try_put(_boundary(mod, 0))
    started.wait(10)                       # the consumer holds boundary 0
    accepted = [pl.try_put(_boundary(mod, i)) for i in (1, 2, 3)]
    blocked = threading.Thread(target=lambda: pl.put(_boundary(mod, 3)))
    blocked.start()
    time.sleep(0.2)                        # put waits on the full queue
    gate.set()
    blocked.join(10)
    assert pl.drain()
    out = {"accepted": accepted, "order": list(seen), "stalls": pl.stalls,
           "max_depth_seen": pl.max_depth_seen, "enqueued": pl.enqueued,
           "processed": pl.processed, "last_row": pl.last_row}
    pl.shutdown()
    return out


def script_drain_barrier(mod):
    seen, inner = [], []
    holder = []

    def consume(b):
        if b.base == 0:
            inner.append(holder[0].drain(timeout_s=1.0))   # own thread
        time.sleep(0.02)
        seen.append(b.base)
        return {"env_steps": float(b.base)}

    pl = mod.AsyncPipeline(4, consume)
    holder.append(pl)
    for i in range(3):
        assert pl.try_put(_boundary(mod, i))
    ok = pl.drain()
    out = {"drained": ok, "seen_at_return": list(seen),
           "processed_at_return": pl.processed, "inner_drain": inner}
    pl.shutdown()
    return out


class InjectedFault(ValueError):
    pass


def script_consumer_fault(mod):
    seen = []

    def consume(b):
        if b.base == 1:
            raise InjectedFault("chunk 1")
        seen.append(b.base)
        return {"env_steps": float(b.base)}

    pl = mod.AsyncPipeline(4, consume)
    for i in range(3):
        assert pl.try_put(_boundary(mod, i))
    drained = pl.drain()
    _wait_for(lambda: pl.processed == pl.enqueued)
    with pytest.raises(InjectedFault) as info:
        raise pl.error                     # the dispatcher's re-raise
    out = {"drained": drained, "seen": seen, "processed": pl.processed,
           "type": type(info.value).__name__, "message": str(info.value),
           "attention": pl.attention.is_set(),
           "put_after_fault": pl.put(_boundary(mod, 3))}
    pl.shutdown()
    return out


def script_attention_rows(mod):
    def consume(b):
        return {"env_steps": float(b.base), "flag": b.heals_mark % 2 == 0}

    pl = mod.AsyncPipeline(8, consume, attn_check=lambda row: row["flag"])
    for i, k in enumerate((1, 4, 1, 4, 1)):
        assert pl.try_put(_boundary(mod, 10 * i, k=k, mark=i))
    assert pl.drain()
    rows = [(row["env_steps"], mark, end)
            for row, mark, end in pl.take_attention()]
    out = {"rows": rows, "attention": pl.attention.is_set(),
           "again": pl.take_attention(), "last_row": pl.last_row}
    pl.shutdown()
    return out


def script_shutdown_discards(mod):
    gate, started, seen = threading.Event(), threading.Event(), []

    def consume(b):
        started.set()
        gate.wait(10)
        seen.append(b.base)
        return {"env_steps": float(b.base)}

    pl = mod.AsyncPipeline(4, consume)
    for i in range(3):
        assert pl.try_put(_boundary(mod, i))
    started.wait(10)
    threading.Timer(0.1, gate.set).start()
    pl.shutdown()
    out = {"seen": seen, "processed": pl.processed,
           "try_put_after": pl.try_put(_boundary(mod, 9))}
    pl.shutdown()                          # idempotent
    return out


SCRIPTS = {
    "blocked_consumer": (script_blocked_consumer, {
        "accepted": [True, True, False], "order": [0, 1, 2, 3], "stalls": 1,
        "max_depth_seen": 2, "enqueued": 4, "processed": 4,
        "last_row": {"env_steps": 3.0}}),
    "drain_barrier": (script_drain_barrier, {
        "drained": True, "seen_at_return": [0, 1, 2],
        "processed_at_return": 3, "inner_drain": [True]}),
    "consumer_fault": (script_consumer_fault, {
        "drained": False, "seen": [0], "processed": 3,
        "type": "InjectedFault", "message": "chunk 1", "attention": True,
        "put_after_fault": False}),
    "attention_rows": (script_attention_rows, {
        "rows": [(0.0, 0, 1), (20.0, 2, 21), (40.0, 4, 41)],
        "attention": True, "again": [], "last_row": {"env_steps": 40.0,
                                                    "flag": True}}),
    "shutdown_discards": (script_shutdown_discards, {
        "seen": [0], "processed": 3, "try_put_after": True}),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_same_script_same_observations(name):
    script, want = SCRIPTS[name]
    got = {pkg: script(mod) for pkg, mod in MODULES.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"] == want


@pytest.mark.parametrize("pkg", sorted(MODULES))
def test_depth_zero_is_refused(pkg):
    with pytest.raises(ValueError, match="depth must be >= 1"):
        MODULES[pkg].AsyncPipeline(0, lambda b: {})
