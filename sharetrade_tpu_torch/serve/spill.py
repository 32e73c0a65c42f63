"""Crash-consistent disk spill tier for parked session carries.

A copy of the JAX package's ``serve/spill.py`` (it imports no JAX; the
port keeps its own copy rather than importing the JAX package), with the
same record format byte for byte, so either package adopts a record the
other sealed. The warm store (``serve/engine.py`` :class:`WarmStore`) is
the RAM half of the warm tier; this module is its overflow: a directory
of per-session carry RECORDS on local disk.

- **one record per session**, named by a content-free digest of the
  session id (``<sha256(sid)[:40]>.spill``): the filesystem is the index,
  so adoption needs no coordination channel and this process keeps no
  per-record map;
- **atomic seal**: a record is built in a ``.tmp-<pid>`` sibling,
  fsync'd, then ``os.replace``d into place, so a reader never observes a
  torn record, only a missing one; a killed writer leaves unsealed debris
  that :func:`sweep_debris` removes;
- **per-record CRC + step stamp**: the fixed header carries the
  session's dispatched-step count (the adoption clock) and a CRC32 over
  meta + payload; a corrupt, truncated or foreign-model record fails
  verification and is deleted, and the caller demotes that session to the
  cold restart through the prefill: corruption can change latency, never
  the answer;
- **consume-on-take**: a successful ``take`` deletes the record, so a
  carry is adopted at most once.

The payload is the concatenated raw bytes of the carry's leaves in
``models/core.tree_leaves`` order (dict keys sorted, the order of
``jax.tree.leaves``); bfloat16 leaves go in as their raw 16-bit patterns.
It is validated against the adopting engine's own carry template by total
byte length (another model or precision fails the check and lands cold).

Threading: the engine confines every arena call to its consumer thread,
except :meth:`SpillArena.probe` (one ``os.stat``, the admission-time
existence check) and the page-out after ``stop``.
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import struct
import zlib
from typing import Any

import numpy as np

from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("serve.spill")

#: Sealed-record filename suffix.
SPILL_SUFFIX = ".spill"

#: Record header: magic, version, flags, step stamp, meta length, payload
#: length, CRC32(meta + payload). Little-endian, fixed size: a record
#: shorter than this is torn by definition.
_HEADER = struct.Struct("<4sHHQIII")
_MAGIC = b"STSP"
_VERSION = 1


def record_name(session_id: Any) -> str:
    """Deterministic arena filename for a session id (every engine, of
    either package, computes the same name: the adoption rendezvous)."""
    digest = hashlib.sha256(str(session_id).encode()).hexdigest()
    return digest[:40] + SPILL_SUFFIX


def sweep_debris(root: str, pid: int | None = None) -> int:
    """Remove unsealed ``.tmp-<pid>`` debris left by crashed writers:
    every tmp file with ``pid=None``, else one dead writer's. Returns the
    number of files removed; sealed records are never touched."""
    removed = 0
    suffix = f".tmp-{pid}" if pid is not None else None
    try:
        entries = os.scandir(root)
    except OSError:
        return 0
    with entries:
        for entry in entries:
            name = entry.name
            if ".tmp-" not in name:
                continue
            if suffix is not None and not name.endswith(suffix):
                continue
            try:
                os.unlink(entry.path)
                removed += 1
            except OSError:
                pass
    if removed:
        log.info("swept %d unsealed spill tmp file(s) from %s (pid=%s)",
                 removed, root, pid)
    return removed


class SpillArena:
    """One engine's handle on the parked-carry arena directory.

    ``record_nbytes`` is the engine's carry footprint (the payload length
    every record written or adopted here must match); ``incarnation`` tags
    records written by this engine life: a take with no session clock
    accepts only its own incarnation's records, so a supervised rebuild
    (which draws a new incarnation) serves only cold re-entries.

    Byte and record counts are kept incrementally and re-anchored by
    :meth:`scan_usage`; approximate between scans (another engine may share
    the directory), never an in-memory record index."""

    def __init__(self, root: str, *, max_bytes: int, record_nbytes: int,
                 incarnation: str):
        self.root = root
        self.max_bytes = int(max_bytes)
        self.record_nbytes = int(record_nbytes)
        self.incarnation = incarnation
        os.makedirs(root, exist_ok=True)
        self.bytes = 0
        self.sessions = 0
        # Event totals (consumer-thread writes; readers see ints).
        self.puts = 0
        self.put_refusals = 0
        self.takes = 0
        self.stale = 0
        self.corrupt = 0

    def _path(self, session_id: Any) -> str:
        return os.path.join(self.root, record_name(session_id))

    def probe(self, session_id: Any) -> bool:
        """True when a sealed record exists for this session (one
        ``os.stat``; the read itself rides the consumer thread)."""
        try:
            return os.stat(self._path(session_id)).st_size > 0
        except OSError:
            return False

    # -- write side ----------------------------------------------------

    def put(self, session_id: Any, leaves: list, steps: int) -> bool:
        """Seal one carry record (write tmp, fsync, rename). ``leaves`` are
        host arrays in tree order. False when the payload is not this
        engine's record size or the byte budget refuses it (that session
        simply stays cold)."""
        payload = b"".join(
            np.ascontiguousarray(leaf).tobytes() for leaf in leaves)
        if len(payload) != self.record_nbytes:
            self.put_refusals += 1
            return False
        meta = json.dumps({
            "session": str(session_id),
            "incarnation": self.incarnation,
            "writer": os.getpid(),
        }).encode()
        size = _HEADER.size + len(meta) + len(payload)
        prev = self._stat_size(session_id)
        if self.bytes - prev + size > self.max_bytes:
            self.put_refusals += 1
            return False
        crc = zlib.crc32(meta + payload) & 0xFFFFFFFF
        header = _HEADER.pack(_MAGIC, _VERSION, 0, int(steps),
                              len(meta), len(payload), crc)
        path = self._path(session_id)
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                f.write(header)
                f.write(meta)
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            log.exception("spill put failed for session %r", session_id)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        self.puts += 1
        self.bytes += size - prev
        if prev == 0:
            self.sessions += 1
        return True

    def _stat_size(self, session_id: Any) -> int:
        try:
            return os.stat(self._path(session_id)).st_size
        except OSError:
            return 0

    def delete(self, session_id: Any) -> None:
        """Tombstone: remove a session's record if one exists (a cold
        re-admission enqueues this, so a stale carry never outlives the
        restart that invalidated it)."""
        size = self._stat_size(session_id)
        try:
            os.unlink(self._path(session_id))
        except OSError:
            return
        self.bytes = max(0, self.bytes - size)
        self.sessions = max(0, self.sessions - 1)

    # -- read side (consume-on-take) -----------------------------------

    def take(self, session_id: Any, expected_steps: int | None = None
             ) -> tuple[bytes | None, int, str, bool]:
        """Adopt one record: verify, consume, return ``(payload, steps,
        reason, foreign)``; ``foreign`` is True when another incarnation
        wrote it. Reasons: ``"hit"`` (verified and consumed: adopt warm),
        ``"miss"`` (no record), ``"stale"`` (the stamp is not the expected
        clock, or with no clock a foreign incarnation: consumed, cold),
        ``"corrupt"`` (torn, CRC-bad or another model's: consumed, cold)."""
        path = self._path(session_id)
        try:
            f = open(path, "rb")
        except OSError:
            return None, 0, "miss", False
        try:
            with f:
                try:
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                except (ValueError, OSError):
                    # Zero-length or vanished underneath us: torn.
                    self._consume(session_id, "corrupt")
                    return None, 0, "corrupt", False
                with mm:
                    parsed = self._parse(mm, session_id)
        except OSError:
            self._consume(session_id, "corrupt")
            return None, 0, "corrupt", False
        if parsed is None:
            self._consume(session_id, "corrupt")
            return None, 0, "corrupt", False
        payload, steps, incarnation = parsed
        foreign = incarnation != self.incarnation
        if expected_steps is not None:
            fresh = steps == int(expected_steps)
        else:
            fresh = not foreign
        if not fresh:
            self._consume(session_id, "stale")
            return None, steps, "stale", foreign
        self._consume(session_id, "hit")
        return payload, steps, "hit", foreign

    def _parse(self, mm, session_id: Any):
        """Verify one mapped record; None on any structural failure."""
        if len(mm) < _HEADER.size:
            return None
        magic, version, _flags, steps, meta_len, payload_len, crc = \
            _HEADER.unpack_from(mm, 0)
        if magic != _MAGIC or version != _VERSION:
            return None
        end = _HEADER.size + meta_len + payload_len
        if payload_len != self.record_nbytes or len(mm) != end:
            return None
        body = mm[_HEADER.size:end]
        if (zlib.crc32(body) & 0xFFFFFFFF) != crc:
            return None
        try:
            meta = json.loads(body[:meta_len].decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        if meta.get("session") != str(session_id):
            # A digest collision with another session: never hand one
            # session another's episode state.
            return None
        return bytes(body[meta_len:]), int(steps), meta.get("incarnation")

    def _consume(self, session_id: Any, reason: str) -> None:
        if reason == "hit":
            self.takes += 1
        elif reason == "stale":
            self.stale += 1
        else:
            self.corrupt += 1
        self.delete(session_id)

    # -- accounting ----------------------------------------------------

    def scan_usage(self) -> tuple[int, int]:
        """Exact ``(bytes, sessions)`` of the sealed records now (one
        ``os.scandir`` pass), re-anchoring the incremental counters."""
        total = count = 0
        try:
            entries = os.scandir(self.root)
        except OSError:
            return self.bytes, self.sessions
        with entries:
            for entry in entries:
                if not entry.name.endswith(SPILL_SUFFIX):
                    continue
                try:
                    total += entry.stat().st_size
                    count += 1
                except OSError:
                    pass
        self.bytes, self.sessions = total, count
        return total, count
