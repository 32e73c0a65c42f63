"""Append-only event journal with replay — the event-sourcing substrate.

A copy of the JAX package's ``data/journal.py`` with its own imports (the
port imports nothing of the JAX package). The on-disk format is the
reference's byte for byte, so both packages read and write the same
``journal/`` files (not at the same moment: the writer lock below refuses
a second live writer).

Reference: Akka Persistence over a LevelDB JNI journal (SharePriceGetter.scala
persist/receiveRecover, application.conf:7-17, build.sbt:18-19). Here the
journal is a framed binary log: each record is

    [u32 length][u32 crc32][payload bytes]

with JSON payloads. CRC framing makes torn tail writes detectable: replay stops
cleanly at the first corrupt/partial record (an interrupted process loses at
most its unflushed tail, never the prefix), which is the recovery contract the
LevelDB journal gave the reference.

The JAX package also has a native C++ writer/reader of the same format; the
port has only this pure-Python backend (see ``data/service.py``).
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Any, Iterator

from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("data.journal")

_HEADER = struct.Struct("<II")  # length, crc32

#: Sealed-segment suffix (``journal_segment_records`` rotation): the active
#: log at ``path`` rotates into ``path.seg00000001``, ``path.seg00000002``,
#: ... — zero-padded so lexical order IS age order.
_SEG_SUFFIX = ".seg"

#: Writer-lock suffix: ``path.lock`` is ``flock``-held (and pid-stamped
#: for forensics) while a :class:`Journal` (or :func:`acquire_writer_lock`
#: caller) owns the path. A SECOND live process opening the same journal
#: would interleave its framed records with the first's — each record is
#: written with one ``write`` call but the OS only guarantees atomicity
#: for small appends, so concurrent writers can tear records in a way the
#: CRC catches only AFTER the damage. The lock makes the torn-record
#: scenario impossible by construction: the actor/learner data plane gives
#: every actor its OWN journal and this guard enforces it.
_LOCK_SUFFIX = ".lock"

#: Locks THIS process holds: lock path -> [fd, refcount]. The kernel keys
#: flock by open-file-description, so in-process re-opens (close/reopen
#: cycles, a reader-side Journal next to the writer) must share ONE fd —
#: a second flock on a fresh fd of the same file would deadlock against
#: ourselves. Refcounted so the first close of a pair doesn't drop the
#: lock out from under the survivor.
_HELD_LOCKS: dict[str, list] = {}
_HELD_LOCKS_GUARD = threading.Lock()


class JournalLockError(RuntimeError):
    """The journal path is already held by another LIVE process."""


def acquire_writer_lock(path: str) -> str:
    """Take the writer lock for ``path``; returns the lock path. Raises
    :class:`JournalLockError` when another LIVE process holds it.

    The authority is a kernel ``flock`` on ``path.lock`` — dropped
    automatically when the holding process dies, so a SIGKILLed writer's
    lock is never stale and there is no sweep step to race (an earlier
    pid-liveness sweep protocol had a TOCTOU hole: two processes sweeping
    the same dead writer's lockfile could both "win" and co-hold the
    journal). The holder's pid is still stamped into the file purely for
    forensics/error messages. A lock held by THIS process is refcounted,
    not an error: in-process re-opens (close/reopen cycles, a reader-side
    Journal) were always legal and remain so — the guard targets
    cross-process interleaving. The lockfile itself is left in place on
    release (unlinking a flock'd file opens a different race: a waiter
    holding the old inode while a third process locks a fresh one)."""
    import fcntl
    # Realpath both the registry key and the lockfile location: two
    # in-process opens of one journal through different spellings
    # (relative vs absolute, a symlink) must resolve to the SAME held
    # entry — a second flock on a fresh fd of the same file would
    # EWOULDBLOCK against ourselves and read as a foreign holder.
    lock = os.path.realpath(path) + _LOCK_SUFFIX
    with _HELD_LOCKS_GUARD:
        held = _HELD_LOCKS.get(lock)
        if held is not None:            # re-entrant within this process
            held[1] += 1
            return lock
        fd = os.open(lock, os.O_CREAT | os.O_RDWR)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
        except BlockingIOError:
            # EAGAIN/EWOULDBLOCK is the ONLY "held by someone" signal;
            # any other OSError (ENOLCK on a lockd-less NFS mount,
            # EINTR) is locking INFRASTRUCTURE failing and must surface
            # as itself, not as a phantom concurrent writer.
            try:
                holder = int(os.read(fd, 64).decode().strip() or 0)
            except (OSError, ValueError):
                holder = 0
            os.close(fd)
            raise JournalLockError(
                f"journal {path} is already held by live process "
                f"{holder or '?'} (lock {lock}); a second writer would "
                "interleave framed records — give each writer its own "
                "journal path") from None
        except OSError:
            os.close(fd)
            raise
        os.ftruncate(fd, 0)
        os.write(fd, str(os.getpid()).encode())
        _HELD_LOCKS[lock] = [fd, 1]
        return lock


def release_writer_lock(path: str) -> None:
    """Drop one hold on the writer lock; the flock releases (and the pid
    stamp clears) when the LAST in-process holder lets go. A path this
    process never locked is a no-op — another process's live lock must
    not be disturbed."""
    lock = os.path.realpath(path) + _LOCK_SUFFIX
    with _HELD_LOCKS_GUARD:
        held = _HELD_LOCKS.get(lock)
        if held is None:
            return
        held[1] -= 1
        if held[1] > 0:
            return
        del _HELD_LOCKS[lock]
        fd = held[0]
        try:
            os.ftruncate(fd, 0)         # stamp cleared: not held
        except OSError:
            pass
        os.close(fd)                    # releases the flock


def _fsync_dir(path: str) -> None:
    """fsync the directory holding ``path`` so a rename/unlink published
    there survives power loss (the checkpoint manager's protocol)."""
    fd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def segment_paths(path: str) -> list[str]:
    """Sealed segments of ``path``, oldest first ([] for single-file
    journals). The active segment — ``path`` itself — is not included."""
    directory = os.path.dirname(os.path.abspath(path)) or "."
    base = os.path.basename(path) + _SEG_SUFFIX
    try:
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith(base) and n[len(base):].isdigit())
    except FileNotFoundError:
        return []
    return [os.path.join(directory, n) for n in names]


def frame_record(payload: bytes) -> bytes:
    """One CRC-framed record (``[u32 length][u32 crc32][payload]``) as
    bytes — the single write-side definition of the frame, shared by the
    full-file writers here, the :class:`Journal` appender, and lightweight
    append-only logs elsewhere (the obs/ span journals) so every framed
    file in the tree replays through :func:`iter_framed_records`."""
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def write_framed_bytes(path: str, payloads: list[bytes]) -> None:
    """Write raw payloads as a complete framed log at ``path`` (fsynced).

    The single definition of the on-disk format for full-file writes:
    compaction goes through here."""
    with open(path, "wb") as f:
        for payload in payloads:
            f.write(frame_record(payload))
        f.flush()
        os.fsync(f.fileno())


def write_framed(path: str, events: list[dict[str, Any]]) -> None:
    """JSON-event form of :func:`write_framed_bytes`."""
    write_framed_bytes(
        path,
        [json.dumps(e, separators=(",", ":")).encode() for e in events])


def iter_framed_records(path: str, *, warn: bool = True) -> Iterator[tuple[int, bytes]]:
    """Yield ``(end_offset, payload)`` for each intact record, stopping at
    the first torn/corrupt one — the single read-side definition of the
    framing (mirrors ``write_framed_bytes`` on the write side).

    Stopping short of the size the file had when the walk started is logged
    (``warn=False`` for callers that log their own recovery action, e.g.
    torn-tail truncation at open): every reader — replay, tail decode,
    compaction — otherwise silently drops whatever sits past the corruption.
    The size is captured up front so records appended concurrently during
    the walk don't masquerade as corruption."""
    if not os.path.exists(path):
        return
    offset = 0
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        while True:
            header = f.read(_HEADER.size)
            if len(header) < _HEADER.size:
                break
            length, crc = _HEADER.unpack(header)
            payload = f.read(length)
            if len(payload) < length or zlib.crc32(payload) != crc:
                break
            offset += _HEADER.size + length
            yield offset, payload
    remaining = size - offset
    if remaining > 0 and warn:
        log.warning("journal %s: corrupt/torn record at offset %d, ignoring "
                    "%d trailing bytes", path, offset, remaining)


class Journal:
    """Durable append-only event log with replay.

    API mirrors the event-sourcing triple the reference uses: ``append``
    (persist), ``replay`` (receiveRecover), and truncation-on-corruption
    recovery semantics.

    **Group commit** (``fsync_every_records`` / ``fsync_interval_s``): with
    either watermark set past the trivial value, appends batch in memory
    and the journal hits the disk — ONE ``write`` + ``flush`` + ``fsync``
    — when the batch reaches ``fsync_every_records`` records or an append
    arrives ``fsync_interval_s`` seconds after the last commit, whichever
    fires first (0 disables that watermark; both are evaluated at append
    time — no background timer, so a sub-watermark batch persists at the
    next append, read, or close). This is what lets a
    per-chunk producer (the DQN transitions journaling of the orchestrator's
    readback consumer) stop paying a syscall round-trip per chunk. The
    recovery contract is UNCHANGED: every committed prefix is a valid
    CRC-framed log, so a crash between watermark commits loses at most the
    unflushed batch and replay stops cleanly at the last intact record —
    the same torn-tail semantics as before (pinned by the property test in
    tests/test_data.py). Readers quiesce the batch first: ``replay``,
    ``__len__`` and compaction all route through :meth:`flush`.
    """

    def __init__(self, path: str, *, fsync: bool = False,
                 fsync_every_records: int = 1,
                 fsync_interval_s: float = 0.0,
                 segment_records: int = 0):
        self.path = path
        self._fsync = fsync
        self._every = max(0, int(fsync_every_records))
        self._interval = max(0.0, float(fsync_interval_s))
        #: Group-commit mode: batch appends, fsync on a watermark.
        self._group = self._every > 1 or self._interval > 0.0
        #: Segment rotation (``data.journal_segment_records``): once the
        #: ACTIVE file holds this many records it is fsynced and renamed
        #: aside as a sealed ``.segNNNNNNNN`` sibling at the next commit,
        #: and appends continue in a fresh active file. Sealed segments
        #: are immutable and fully durable; a torn tail can only ever
        #: live in the active segment (the same recovery contract,
        #: per segment). 0 = single-file journal.
        self._segment_records = max(0, int(segment_records))
        self._buf: list[bytes] = []
        self._buf_records = 0
        self._last_commit = time.monotonic()
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        # Concurrent-writer guard: the flock'd lockfile raises LOUDLY
        # when another live process already owns this path (two writers
        # would interleave framed records); a dead writer's flock died
        # with it. Released at close().
        acquire_writer_lock(self.path)
        self._lock_held = True
        try:
            valid = self._scan_valid_prefix()
            # Truncate any torn tail so appends continue from a clean
            # boundary (sealed segments were fsynced before publication —
            # only the active segment can tear).
            if valid is not None:
                with open(self.path, "r+b") as f:
                    f.truncate(valid)
            self._fh = open(self.path, "ab")
            #: Records currently in the active segment — counted during
            #: the torn-tail prefix scan above (one walk of the active
            #: file, not a second one; a migrating pre-rotation journal
            #: can be large).
            self._seg_records = self._scanned_records
        except BaseException:
            # A failed construction must not leak the writer lock for
            # the process lifetime (nothing holds a handle to release).
            self._lock_held = False
            release_writer_lock(self.path)
            raise

    # ---- write path ----

    def append(self, event: dict[str, Any]) -> None:
        self.append_bytes(json.dumps(event, separators=(",", ":")).encode())

    def append_bytes(self, payload: bytes) -> None:
        """Append a raw (possibly binary) payload — the packed-transition
        codec (data/transitions.py) frames through here."""
        record = _HEADER.pack(len(payload), zlib.crc32(payload)) + payload
        with self._lock:
            if self._group:
                if self._fh.closed:
                    # Match the legacy path (write() on a closed handle
                    # raises): buffering after close would ack records
                    # that can never reach the disk.
                    raise ValueError(
                        f"append to closed journal {self.path}")
                self._buf.append(record)
                self._buf_records += 1
                if ((self._every and self._buf_records >= self._every)
                        or (self._interval
                            and time.monotonic() - self._last_commit
                            >= self._interval)):
                    self._commit_locked()
                return
            self._fh.write(record)
            self._fh.flush()
            if self._fsync:
                os.fsync(self._fh.fileno())
            self._seg_records += 1
            self._maybe_rotate_locked()

    def _commit_locked(self) -> None:
        """Flush the batched records as one write + one fsync (group-commit
        mode) or flush the OS handle (legacy mode). Lock held by caller."""
        if self._fh.closed:
            return
        if self._buf:
            self._fh.write(b"".join(self._buf))
            self._seg_records += self._buf_records
            self._buf.clear()
            self._buf_records = 0
        self._fh.flush()
        if self._group or self._fsync:
            os.fsync(self._fh.fileno())
        self._last_commit = time.monotonic()
        self._maybe_rotate_locked()

    def _maybe_rotate_locked(self) -> None:
        """Seal the active segment once it reaches ``segment_records``
        (checked at commit/append time — "rotate on watermark flush"): the
        active file is fsynced, renamed to the next ``.segNNNNNNNN`` name
        (so its bytes are durable BEFORE the rename publishes it), the
        directory entry is fsynced, and a fresh active file opens. Lock
        held by caller; every committed record lands in exactly one
        segment."""
        if (not self._segment_records
                or self._seg_records < self._segment_records
                or self._fh.closed):
            return
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        seals = segment_paths(self.path)
        prefix = os.path.basename(self.path) + _SEG_SUFFIX
        last = (int(os.path.basename(seals[-1])[len(prefix):])
                if seals else 0)
        sealed = f"{self.path}{_SEG_SUFFIX}{last + 1:08d}"
        os.replace(self.path, sealed)
        _fsync_dir(self.path)
        self._fh = open(self.path, "ab")
        self._seg_records = 0
        log.info("journal %s: sealed segment %s", self.path,
                 os.path.basename(sealed))

    def flush(self) -> None:
        """Make every append that returned durable (and visible to readers
        of ``path``) NOW, regardless of watermarks — the drain-barrier hook
        the orchestrator and compaction call before any read."""
        with self._lock:
            self._commit_locked()

    # ---- read path ----

    def replay(self) -> Iterator[dict[str, Any]]:
        """Yield all intact events from the start of the log — sealed
        segments oldest-first, then the active segment."""
        self.flush()
        for path in (*segment_paths(self.path), self.path):
            for _offset, payload in iter_framed_records(path):
                if payload[:4] == b"STR1":
                    # Packed binary transition record (data/transitions.py):
                    # not a JSON event — decoded by read_tail_transitions.
                    continue
                yield json.loads(payload)

    def _scan_valid_prefix(self) -> int | None:
        """Byte offset of the last intact record boundary, or None if the file
        doesn't exist / is fully intact (nothing to truncate). A trailing
        partial header counts as torn — appending after one would bury every
        later record behind an unreadable frame."""
        self._scanned_records = 0
        if not os.path.exists(self.path):
            return None
        end = 0
        # warn=False: this path logs its own, action-bearing message below.
        # The record count rides the same walk (seeds _seg_records for
        # rotation — no second full scan of the active file).
        for end, _payload in iter_framed_records(self.path, warn=False):
            self._scanned_records += 1
        if end == os.path.getsize(self.path):
            return None
        log.warning("journal %s: torn tail at offset %d, truncating",
                    self.path, end)
        return end

    # ---- compaction ----

    def compact(self, events: list[dict[str, Any]]) -> None:
        """Atomically replace the log's contents with ``events`` — the
        event-sourcing compaction the reference delegates to LevelDB
        (application.conf:7-14 configures per-actor compaction intervals).
        The caller supplies the collapsed event set (e.g. one snapshot event
        per symbol) and must ensure it reflects every acked append; a crash
        mid-compaction leaves the original log intact (write-temp + atomic
        rename, same protocol as checkpoints). The lock is held for the
        whole rewrite so a concurrent ``append`` lands after the swap rather
        than vanishing into the replaced file."""
        self.compact_payloads(
            [json.dumps(e, separators=(",", ":")).encode() for e in events])

    def compact_payloads(self, payloads: list[bytes]) -> None:
        """Raw-payload form of :meth:`compact` (same atomic protocol) — the
        transitions journal compacts binary records through here."""
        tmp_path = f"{self.path}.compact-{os.getpid()}"
        with self._lock:
            # Any group-commit batch is superseded: the caller's payload set
            # must already reflect every acked append (it reads through
            # replay()/flush(), which commit the batch first).
            self._buf.clear()
            self._buf_records = 0
            write_framed_bytes(tmp_path, payloads)
            self._fh.close()
            os.replace(tmp_path, self.path)
            # Compaction replaces the WHOLE log: sealed segments are part
            # of it, so they go too (their content is superseded by the
            # caller's payload set, same as the active file's).
            for sealed in segment_paths(self.path):
                os.remove(sealed)
            _fsync_dir(self.path)
            self._fh = open(self.path, "ab")
            self._seg_records = len(payloads)
            self._last_commit = time.monotonic()
        log.info("journal %s compacted to %d records", self.path, len(payloads))

    def __len__(self) -> int:
        return sum(1 for _ in self.replay())

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._commit_locked()
                self._fh.close()
            if getattr(self, "_lock_held", False):
                release_writer_lock(self.path)
                self._lock_held = False

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
