"""Atomic, checksummed, retained, resumable checkpoints of a ``TrainState``.

Counterpart of the JAX package's ``checkpoint/manager.py``, with the same
protocol and layout; only the payload differs:

    <dir>/ckpt_0000000500/state.npz   the TrainState's leaves by dotted name
    <dir>/ckpt_0000000500/meta.json   step, wall time, sha256s, user metadata

The payload is an uncompressed ``.npz`` of ``convert.train_state_leaves``
(``params.*``, ``opt_state.*``, ``carry.*``, ``env_state.*``,
``env_steps``, ``updates``, and ``rng``: the generator's ``get_state()``
bytes, so a resumed run draws what the uninterrupted run would have drawn).
bfloat16 leaves are stored as their ``uint16`` bits, and ``meta.json``
records their dtype (``"dtypes": {"carry.k": "bfloat16"}``): a bitwise round
trip at half the bytes of a float32 upcast. It is read with
``allow_pickle=False``.

Write protocol: payload and checksummed ``meta.json`` are staged in
``<dir>/tmp-<step>-<pid>``, then ``os.replace``d to the final name; with
``fsync`` on (``checkpoint.fsync``) the payload files, the staged directory
and the parent are fsynced around the rename, so a checkpoint that looks
complete is complete. ``meta.json`` holds a SHA-256 of the payload and one
of its own canonical bytes, so torn or flipped bytes are found at restore.

Foreign directories: a ``ckpt_*`` or ``tag_*`` directory with no
``state.npz`` that holds a ``state.msgpack`` (or whose meta names one) was
written by the JAX package. The port lists, walks into, quarantines,
prunes and overwrites none of them; asked for one by step or by tag it
raises :class:`ForeignCheckpointError`. The two packages still want
separate ``runtime.checkpoint_dir`` values: the JAX manager quarantines the
port's directories as its own kind of damage.

Restore protocol: every candidate is verified (checksums, a match with the
caller's template — names, shapes, dtypes, the generator's state size — and
finite params and optimizer state) before it is accepted. A damaged one is
quarantined (renamed ``corrupt_<step>_<reason>``, never deleted) and the
restore walks back to the next older step. A checksum-intact checkpoint that
does not match the template is a config change, not damage: it raises
``ValueError`` and nothing is renamed.

The newest ``keep`` step checkpoints are retained; older ones are pruned
after a good save. Stale ``tmp-*`` directories of dead writers are swept at
construction, and a complete one is published instead (it only missed its
rename). Tagged checkpoints (``tag_best``, ``tag_preempt``) live outside the
step namespace and keep their previous copy as ``.old`` while being
replaced.

:meth:`CheckpointManager.save_async` keeps the caller's share small: on the
card it only enqueues copies of every leaf into pinned host buffers on a
side stream, records an event, and makes the caller's stream wait for it
(the next chunk updates the parameters in place); a writer thread waits for
the event, then hashes, writes and fsyncs. ``save_stats`` keeps, per save,
the caller's host time (``loop_ms``), the copies' device time (``d2h_ms``),
the writer's time (``writer_ms``) and the payload's bytes.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import io
import json
import os
import queue
import shutil
import threading
import time
import zipfile
from typing import Any

import numpy as np
import torch

from sharetrade_tpu_torch.convert import (
    decode_leaf, decode_train_state, encode_train_state, flatten,
    train_state_leaves, unflatten)
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("checkpoint")

_PREFIX = "ckpt_"
_CORRUPT_PREFIX = "corrupt_"
_STATE = "state.npz"
_META = "meta.json"
#: The JAX package's payload: a directory holding it is foreign.
_FOREIGN_STATE = "state.msgpack"
#: Leaves the shared-state finiteness check covers (every agent row
#: depends on them; env rows and carries may hold a quarantined row's NaN).
_SHARED = ("params.", "opt_state.")


class CheckpointIntegrityError(RuntimeError):
    """One checkpoint directory failed verification; ``reason`` is the
    machine-readable slug that lands in the quarantine directory name."""

    def __init__(self, reason: str, detail: str):
        super().__init__(f"{reason}: {detail}")
        self.reason = reason


class ForeignCheckpointError(ValueError):
    """The checkpoint directory was written by the JAX package (its payload
    is ``state.msgpack``, not ``state.npz``). The port never reads, renames,
    prunes or overwrites such a directory; asked for one by step or tag, it
    raises this, a ``ValueError`` like a template mismatch."""


def is_foreign(path: str) -> bool:
    """A checkpoint dir with no ``state.npz`` that holds a
    ``state.msgpack`` or whose ``meta.json`` integrity block names one: the
    JAX package's layout."""
    if os.path.isfile(os.path.join(path, _STATE)):
        return False
    if os.path.isfile(os.path.join(path, _FOREIGN_STATE)):
        return True
    try:
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return False
    integrity = meta.get("integrity") if isinstance(meta, dict) else None
    return isinstance(integrity, dict) and _FOREIGN_STATE in integrity


def _refuse_foreign(path: str) -> None:
    if is_foreign(path):
        raise ForeignCheckpointError(
            f"{path} is a checkpoint of the JAX package (state.msgpack); "
            "this package reads and writes only its own state.npz "
            "checkpoints: give the two packages separate "
            "runtime.checkpoint_dir values")


class CheckpointCorruptError(FileNotFoundError):
    """No intact checkpoint could be restored (everything quarantined, or an
    explicitly requested step failed verification). A ``FileNotFoundError``,
    so every restore-or-reinit fallback treats "all corrupt" like "none
    saved yet"."""


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True       # exists, owned by someone else
    except (OverflowError, ValueError, OSError):
        return False
    return True


def _fsync_dir(path: str) -> None:
    """fsync a directory so its entries (the renamed name) are durable."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _canonical_meta_bytes(meta: dict[str, Any]) -> bytes:
    """The bytes ``meta_sha256`` is computed over: the meta dict minus its
    own digest, canonically serialised."""
    meta = dict(meta)
    integrity = dict(meta.get("integrity", {}))
    integrity.pop("meta_sha256", None)
    meta["integrity"] = integrity
    return json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()


def verify_checkpoint_files(path: str, *,
                            state_bytes: bytes | None = None
                            ) -> dict[str, Any]:
    """File-level integrity of one checkpoint dir: both files present, meta
    parses, and (when the meta carries them) both SHA-256s match. Returns
    the parsed metadata; raises :class:`CheckpointIntegrityError` with a
    quarantine-reason slug otherwise. ``state_bytes``: the payload when the
    caller has already read it (restore does)."""
    meta_path = os.path.join(path, _META)
    state_path = os.path.join(path, _STATE)
    if not os.path.isfile(meta_path):
        raise CheckpointIntegrityError("meta_missing", f"{meta_path} absent")
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        if not isinstance(meta, dict):
            raise ValueError("meta.json is not an object")
    except (ValueError, OSError) as exc:
        raise CheckpointIntegrityError("meta_garbled", str(exc)) from exc
    if state_bytes is None and not os.path.isfile(state_path):
        raise CheckpointIntegrityError("state_missing",
                                       f"{state_path} absent")
    integrity = meta.get("integrity")
    if integrity:
        expected_meta = integrity.get("meta_sha256")
        if expected_meta:
            actual = hashlib.sha256(_canonical_meta_bytes(meta)).hexdigest()
            if actual != expected_meta:
                raise CheckpointIntegrityError(
                    "meta_checksum",
                    f"meta.json sha256 {actual} != {expected_meta}")
        expected_state = integrity.get(_STATE)
        if expected_state:
            h = hashlib.sha256()
            if state_bytes is not None:
                h.update(state_bytes)
            else:
                try:
                    with open(state_path, "rb") as f:
                        for block in iter(lambda: f.read(1 << 20), b""):
                            h.update(block)
                except OSError as exc:
                    raise CheckpointIntegrityError(
                        "state_unreadable",
                        f"{type(exc).__name__}: {exc}") from exc
            if h.hexdigest() != expected_state:
                raise CheckpointIntegrityError(
                    "state_checksum",
                    f"{_STATE} sha256 {h.hexdigest()} != {expected_state}")
    return meta


def _write_npz(path: str, arrays: dict[str, np.ndarray]) -> tuple[str, int]:
    """Write ``arrays`` as an uncompressed ``.npz`` (what ``np.savez``
    writes) and return its SHA-256 and size. Each array's bytes go from a
    view of its buffer through zlib's CRC and the file write, both of which
    release the GIL, so a writer thread holds the GIL for no copy of the
    payload; the digest is read back from the file the same way."""
    from numpy.lib import format as npy
    with open(path, "wb") as f, zipfile.ZipFile(
            f, "w", zipfile.ZIP_STORED, allowZip64=True) as zf:
        for name, a in arrays.items():
            a = a if a.flags.c_contiguous else a.copy(order="C")
            with zf.open(f"{name}.npy", "w", force_zip64=True) as out:
                npy.write_array_header_1_0(
                    out, npy.header_data_from_array_1_0(a))
                out.write(memoryview(a.reshape(-1).view(np.uint8)))
    h = hashlib.sha256()
    buf = bytearray(16 << 20)
    view = memoryview(buf)
    size = 0
    with open(path, "rb", buffering=0) as f:
        while n := f.readinto(buf):
            h.update(view[:n])
            size += n
    return h.hexdigest(), size


def _torch_dtype(a: np.ndarray, stored: str | None) -> torch.dtype:
    if stored == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, a.dtype)).dtype


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, fsync: bool = True,
                 precision_mode: str | None = None, tracer: Any = None):
        self.directory = directory
        self.keep = keep
        #: Precision contract of the run, stamped into every save's
        #: meta.json and checked at restore (the compute-dtype carry rides
        #: the state). None: neither stamp nor check.
        self.precision_mode = precision_mode
        self.fsync = fsync
        #: ``ckpt_quarantined_total`` and ``ckpt_restore_fallbacks_total``.
        self.counters: collections.Counter = collections.Counter()
        #: The most recent restore: the step served, the candidates
        #: quarantined and skipped, the verified metadata and its seconds.
        self.last_restore_report: dict[str, Any] = {}
        #: Per save: step, bytes, loop_ms / d2h_ms (async saves), writer_ms.
        self.save_stats: collections.deque = collections.deque(maxlen=256)
        os.makedirs(directory, exist_ok=True)
        self._worker: threading.Thread | None = None
        self._queue: queue.Queue | None = None
        self._inflight = 0
        self._cv = threading.Condition()
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        #: Optional obs ``SpanTracer`` (settable post-construction): save,
        #: snapshot and restore phases land in the host trace, including
        #: writes on the writer thread (the tracer is thread-safe).
        self.tracer = tracer
        self._sweep_stale_tmp()

    def _span(self, name: str, **args: Any):
        if self.tracer is None:
            return contextlib.nullcontext()
        return self.tracer.span(name, **args)

    def _instant(self, name: str, **args: Any) -> None:
        if self.tracer is not None:
            try:
                self.tracer.instant(name, **args)
            except Exception:
                pass        # observability never outranks the checkpoint

    # ---- crashed writers ----

    def _sweep_stale_tmp(self) -> None:
        """Handle ``tmp-<label>-<pid>`` dirs of dead writers: a complete
        step checkpoint is published under its ``ckpt_`` name, anything
        else is removed. A live pid's dir belongs to a concurrent saver and
        is left alone."""
        for name in os.listdir(self.directory):
            if not name.startswith("tmp-"):
                continue
            try:
                pid = int(name.rsplit("-", 1)[-1])
            except ValueError:
                continue
            full = os.path.join(self.directory, name)
            if pid == os.getpid() or _pid_alive(pid) or is_foreign(full):
                continue
            if self._recover_tmp(full, name) == "debris":
                shutil.rmtree(full, ignore_errors=True)
                log.info("swept stale checkpoint tmp dir %s (pid %d dead)",
                         name, pid)

    def _recover_tmp(self, full: str, name: str) -> str:
        """Publish a dead writer's fully staged step checkpoint. Returns
        ``"recovered"``, ``"debris"`` (incomplete, a tag, or a duplicate)
        or ``"keep"`` (verified bytes whose publish failed: not deleted)."""
        try:
            meta = verify_checkpoint_files(full)
        except CheckpointIntegrityError:
            return "debris"
        step = meta.get("step")
        if not isinstance(step, int) or "tag" in meta:
            return "debris"
        final = os.path.join(self.directory, f"{_PREFIX}{step:010d}")
        if os.path.exists(final):
            return "debris"
        try:
            if self.fsync:
                for fname in (_STATE, _META):
                    _fsync_file(os.path.join(full, fname))
                _fsync_dir(full)
            os.replace(full, final)
        except OSError:
            return "keep"
        if self.fsync:
            _fsync_dir(self.directory)
        log.warning("recovered complete checkpoint step=%d from crashed "
                    "writer tmp dir %s", step, name)
        return "recovered"

    # ---- save ----

    def _meta(self, head: dict[str, Any], metadata: dict[str, Any] | None,
              dtypes: dict[str, str]) -> dict[str, Any]:
        meta = {**head, "saved_at": time.time(), **(metadata or {})}
        if self.precision_mode is not None:
            meta.setdefault("precision_mode", self.precision_mode)
        meta["dtypes"] = dtypes
        return meta

    def _write_payload_tmp(self, tmp: str, arrays: dict[str, np.ndarray],
                           meta: dict[str, Any]) -> int:
        """Stage the payload and checksummed meta into ``tmp`` and make the
        bytes durable; no name is published yet. Returns the payload's
        size."""
        os.makedirs(tmp, exist_ok=True)
        state_path = os.path.join(tmp, _STATE)
        digest, size = _write_npz(state_path, arrays)
        if self.fsync:
            _fsync_file(state_path)
        meta = dict(meta)
        meta["integrity"] = {"algo": "sha256", _STATE: digest}
        meta["integrity"]["meta_sha256"] = hashlib.sha256(
            _canonical_meta_bytes(meta)).hexdigest()
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f, sort_keys=True)
            if self.fsync:
                f.flush()
                os.fsync(f.fileno())
        if self.fsync:
            _fsync_dir(tmp)
        return size

    def _publish(self, tmp: str, final: str) -> None:
        """Atomically publish a staged tmp dir under ``final`` (a same-step
        re-save replaces the old copy; a crash between the two leaves the
        staged dir for :meth:`_recover_tmp`). A foreign dir under ``final``
        is refused, never replaced."""
        _refuse_foreign(final)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self.fsync:
            _fsync_dir(self.directory)

    def _write_step(self, step: int, arrays: dict[str, np.ndarray],
                    dtypes: dict[str, str], metadata: dict[str, Any] | None,
                    stats: dict[str, Any]) -> str:
        t0 = time.perf_counter()
        meta = self._meta({"step": int(step)}, metadata, dtypes)
        tmp = os.path.join(self.directory, f"tmp-{step}-{os.getpid()}")
        final = os.path.join(self.directory, f"{_PREFIX}{step:010d}")
        size = self._write_payload_tmp(tmp, arrays, meta)
        self._publish(tmp, final)
        stats.update(step=int(step), bytes=size,
                     writer_ms=(time.perf_counter() - t0) * 1e3)
        self.save_stats.append(stats)
        log.info("saved checkpoint step=%d (%d bytes)", step, size)
        self._prune()
        return final

    def save(self, step: int, train_state: Any,
             metadata: dict[str, Any] | None = None) -> str:
        """Write a step checkpoint now, on the caller's thread."""
        with self._span("checkpoint_save", step=int(step)):
            arrays, dtypes = encode_train_state(
                train_state_leaves(train_state))
            return self._write_step(step, arrays, dtypes, metadata, {})

    def save_tagged(self, tag: str, train_state: Any,
                    metadata: dict[str, Any] | None = None) -> str:
        """Save under a name instead of a step (``tag_best``,
        ``tag_preempt``), outside the pruned ``ckpt_`` namespace, with the
        same protocol. The new payload is staged completely before the live
        tag moves aside to ``.old``, so a failure at any point leaves the
        old or the new copy readable."""
        arrays, dtypes = encode_train_state(train_state_leaves(train_state))
        meta = self._meta({"tag": tag}, metadata, dtypes)
        tmp = os.path.join(self.directory, f"tmp-{tag}-{os.getpid()}")
        final = os.path.join(self.directory, f"tag_{tag}")
        _refuse_foreign(final)
        size = self._write_payload_tmp(tmp, arrays, meta)
        if os.path.isdir(final):
            old = final + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(final, old)
            self._publish(tmp, final)
            shutil.rmtree(old, ignore_errors=True)
        else:
            self._publish(tmp, final)
        log.info("saved tagged checkpoint %r (%d bytes)", tag, size)
        return final

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    def _to_host(self, leaves: dict[str, Any]):
        """Host copies of every leaf the caller's next step may overwrite:
        on the card, pinned buffers filled on a side stream (returns the
        start and end events); on the CPU, clones."""
        cuda = [v for v in leaves.values() if v.is_cuda]
        if not cuda:
            return {k: v.detach().clone() for k, v in leaves.items()}, None
        device = cuda[0].device
        # Pinned buffers first (the caching host allocator hands back those
        # of a save whose writer has finished), so the events below time
        # the copies alone.
        host = {name: (torch.empty(leaf.shape, dtype=leaf.dtype,
                                   pin_memory=True)
                       if leaf.is_cuda else leaf.detach().clone())
                for name, leaf in leaves.items()}
        current = torch.cuda.current_stream(device)
        side = self._stream(device)
        side.wait_stream(current)
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            start.record(side)
            for name, leaf in leaves.items():
                if leaf.is_cuda:
                    host[name].copy_(leaf.detach(), non_blocking=True)
            done.record(side)
        # The caller's stream must not overwrite a leaf before its copy.
        current.wait_event(done)
        return host, (start, done)

    def save_async(self, step: int, train_state: Any,
                   metadata: dict[str, Any] | None = None) -> None:
        """Minimal-stall save: the caller only enqueues the host copies;
        encoding, hashing and disk IO run on a writer thread. Call
        :meth:`wait_pending` before reading the directory."""
        t0 = time.perf_counter()
        with self._span("checkpoint_snapshot", step=int(step)):
            host, events = self._to_host(train_state_leaves(train_state))
        stats = {"loop_ms": (time.perf_counter() - t0) * 1e3}
        if self._worker is None:
            self._queue = queue.Queue()
            self._worker = threading.Thread(
                target=self._drain, name="ckpt-writer", daemon=True)
            self._worker.start()
        with self._cv:
            self._inflight += 1
        self._queue.put((step, host, events, metadata, stats))

    def _drain(self) -> None:
        while True:
            job = self._queue.get()
            try:
                self._write_job(*job)
            except Exception:  # never kill the writer thread
                log.exception("async checkpoint save failed (step=%d)",
                              job[0])
            finally:
                # Drop the host buffers now: the next save reuses them.
                del job
                with self._cv:
                    self._inflight -= 1
                    self._cv.notify_all()

    def _write_job(self, step: int, host: dict[str, Any], events,
                   metadata: dict[str, Any] | None,
                   stats: dict[str, Any]) -> None:
        with self._span("checkpoint_save", step=int(step)):
            if events is not None:
                start, done = events
                done.synchronize()
                stats["d2h_ms"] = start.elapsed_time(done)
            arrays, dtypes = encode_train_state(host)
            self._write_step(step, arrays, dtypes, metadata, stats)

    def wait_pending(self, timeout: float | None = None) -> bool:
        """Block until every queued or mid-write async save is on disk."""
        with self._cv:
            return self._cv.wait_for(lambda: self._inflight == 0, timeout)

    # ---- verification ----

    @staticmethod
    def _check_template(arrays: dict[str, np.ndarray],
                        dtypes: dict[str, str], want: dict[str, Any]) -> None:
        """Raise ``ValueError`` naming the first difference between the
        stored leaves and the template's."""
        if set(arrays) != set(want):
            raise ValueError(
                f"leaves differ: missing {sorted(set(want) - set(arrays))}, "
                f"unexpected {sorted(set(arrays) - set(want))}")
        for name, leaf in want.items():
            a = arrays[name]
            got = (tuple(a.shape), _torch_dtype(a, dtypes.get(name)))
            if got != (tuple(leaf.shape), leaf.dtype):
                raise ValueError(f"{name}: stored {got}, template "
                                 f"{(tuple(leaf.shape), leaf.dtype)}")

    def _load_verified(self, path: str, template: Any) -> tuple[Any, dict]:
        """Checksums, then the template match, then finite shared leaves.
        Raises :class:`CheckpointIntegrityError`, or ``ValueError`` for a
        checksum-intact checkpoint of another config."""
        try:
            with open(os.path.join(path, _STATE), "rb") as f:
                payload = f.read()
        except FileNotFoundError:
            payload = None      # verify below raises the state_missing slug
        except OSError as exc:
            raise CheckpointIntegrityError(
                "state_unreadable", f"{type(exc).__name__}: {exc}") from exc
        meta = verify_checkpoint_files(path, state_bytes=payload)
        self._check_precision(meta, path)
        dtypes = meta.get("dtypes") or {}
        # A bare params tree as the template restores the params alone.
        params_only = not hasattr(template, "params")
        want = (flatten(template, "params", leaf=lambda x: x) if params_only
                else train_state_leaves(template))
        try:
            with np.load(io.BytesIO(payload), allow_pickle=False) as data:
                arrays = {k: data[k] for k in data.files
                          if not params_only or k.startswith("params.")}
            self._check_template(arrays, dtypes, want)
        except Exception as exc:
            if meta.get("integrity", {}).get(_STATE):
                # The checksum verified: these are the bytes that were
                # written, so this is a config change, not damage.
                raise ValueError(
                    f"checkpoint at {path} is checksum-intact but does not "
                    f"deserialize into the provided template "
                    f"({type(exc).__name__}: {exc}); was the model/"
                    "optimizer config changed since it was saved?") from exc
            raise CheckpointIntegrityError(
                "undeserializable", f"{type(exc).__name__}: {exc}") from exc
        device = next(iter(want.values())).device
        if params_only:
            leaves = {k: decode_leaf(a, dtypes.get(k)).to(device)
                      for k, a in arrays.items()}
            state = unflatten({k.removeprefix("params."): v
                               for k, v in leaves.items()})
        else:
            state = decode_train_state(arrays, dtypes, device=device)
            leaves = train_state_leaves(state)
        for name, leaf in leaves.items():
            if (name.startswith(_SHARED) and leaf.is_floating_point()
                    and not bool(torch.isfinite(leaf).all())):
                raise CheckpointIntegrityError(
                    "nonfinite", f"non-finite value in {name}")
        return state, meta

    def _check_precision(self, meta: dict[str, Any], path: str) -> None:
        """Refuse a precision-mode-mismatched restore loudly (the bytes are
        intact; the config changed). Checkpoints without a mode are fp32."""
        if self.precision_mode is None:
            return
        saved = meta.get("precision_mode", "fp32")
        if saved != self.precision_mode:
            raise ValueError(
                f"checkpoint at {path} was saved under precision.mode="
                f"{saved!r} but this run is configured with "
                f"{self.precision_mode!r}; restore refuses a mode mismatch "
                "(master weights are always fp32, but the compute-dtype "
                "carry differs). Set precision.mode accordingly, or start "
                "fresh without --resume.")

    def verify(self, step: int | None = None) -> dict[str, Any]:
        """Files and checksums of one step checkpoint (newest when ``step``
        is None), without a template. Returns its metadata."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints under {self.directory}")
        return verify_checkpoint_files(
            os.path.join(self.directory, f"{_PREFIX}{step:010d}"))

    def _quarantine(self, path: str, label: Any, reason: str) -> None:
        """Rename a damaged checkpoint aside; never delete it."""
        base = os.path.join(self.directory,
                            f"{_CORRUPT_PREFIX}{label}_{reason}")
        dest, n = base, 1
        while os.path.exists(dest):
            n += 1
            dest = f"{base}-{n}"
        try:
            os.replace(path, dest)
        except OSError:
            log.exception("failed to quarantine corrupt checkpoint %s", path)
            return
        self.counters["ckpt_quarantined_total"] += 1
        self._instant("ckpt_quarantined", label=str(label), reason=reason)
        log.error("quarantined corrupt checkpoint %s -> %s (%s)",
                  os.path.basename(path), os.path.basename(dest), reason)

    # ---- restore ----

    def steps(self) -> list[int]:
        """Every ``ckpt_<step>`` directory of this package, intact or not
        (so the walk-back can find, quarantine and step over damaged ones);
        foreign (JAX) ones are left out, so nothing walks into, quarantines
        or prunes them."""
        out = []
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if (name.startswith(_PREFIX) and os.path.isdir(path)
                    and not is_foreign(path)):
                try:
                    out.append(int(name[len(_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def any_intact(self) -> bool:
        """Does at least one step checkpoint pass file-level verification?"""
        for s in reversed(self.steps()):
            try:
                verify_checkpoint_files(
                    os.path.join(self.directory, f"{_PREFIX}{s:010d}"))
                return True
            except CheckpointIntegrityError:
                continue
        return False

    def restore(self, template: Any, step: int | None = None
                ) -> tuple[Any, int]:
        """Restore onto ``template``'s structure and device (a
        ``TrainState``, or a params tree to restore the params alone).
        Returns ``(state, step)``. A damaged candidate is quarantined and, unless
        ``step`` was requested, the next older one is tried; an explicit
        step that fails, or no intact candidate at all, raises
        :class:`CheckpointCorruptError`."""
        explicit = step is not None
        candidates = [step] if explicit else list(reversed(self.steps()))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        skipped: list[tuple[int, str]] = []
        for s in candidates:
            path = os.path.join(self.directory, f"{_PREFIX}{s:010d}")
            if not os.path.isdir(path):
                raise FileNotFoundError(f"no checkpoint step={s} under "
                                        f"{self.directory}")
            _refuse_foreign(path)
            t0 = time.perf_counter()
            with self._span("checkpoint_restore", step=int(s)):
                try:
                    state, meta = self._load_verified(path, template)
                except CheckpointIntegrityError as exc:
                    self._quarantine(path, f"{s:010d}", exc.reason)
                    skipped.append((s, exc.reason))
                    if explicit:
                        raise CheckpointCorruptError(
                            f"checkpoint step={s} failed verification "
                            f"({exc.reason}); quarantined") from exc
                    self.counters["ckpt_restore_fallbacks_total"] += 1
                    continue
            self.last_restore_report = {
                "step": int(s), "skipped": skipped, "meta": meta,
                "seconds": time.perf_counter() - t0}
            if skipped:
                log.warning("restore fell back to step=%d past %d corrupt "
                            "checkpoint(s) %s (quarantined, not deleted)",
                            s, len(skipped), skipped)
            else:
                log.info("restored checkpoint step=%d", s)
            return state, s
        raise CheckpointCorruptError(
            f"every checkpoint under {self.directory} failed verification "
            f"({skipped}); all quarantined, none deleted")

    def restore_tagged(self, template: Any, tag: str) -> tuple[Any, dict]:
        """Restore a tagged checkpoint; returns ``(state, metadata)``. A
        corrupt primary is quarantined (``corrupt_tag_<tag>_<reason>``) and
        its ``.old`` copy tried; both bad raises
        :class:`CheckpointCorruptError`."""
        primary = os.path.join(self.directory, f"tag_{tag}")
        candidates = [p for p in (primary, primary + ".old")
                      if os.path.isdir(p)]
        if not candidates:
            raise FileNotFoundError(
                f"no {tag!r}-tagged checkpoint under {self.directory}")
        _refuse_foreign(candidates[0])
        candidates = [p for p in candidates if not is_foreign(p)]
        for path in candidates:
            try:
                state, meta = self._load_verified(path, template)
            except CheckpointIntegrityError as exc:
                self._quarantine(path, f"tag_{tag}", exc.reason)
                continue
            if path != primary:
                self.counters["ckpt_restore_fallbacks_total"] += 1
                log.warning("restored tagged checkpoint %r from its .old "
                            "crash-window copy", tag)
            log.info("restored tagged checkpoint %r", tag)
            return state, meta
        raise CheckpointCorruptError(
            f"every {tag!r}-tagged checkpoint under {self.directory} failed "
            "verification (quarantined, not deleted)")

    def tagged_metadata(self, tag: str) -> dict[str, Any] | None:
        """Metadata of a tagged checkpoint, or None if absent or garbled;
        unverified (a hint: :meth:`restore_tagged` verifies); None for a
        foreign (JAX) tag."""
        for name in (f"tag_{tag}", f"tag_{tag}.old"):
            if is_foreign(os.path.join(self.directory, name)):
                continue
            path = os.path.join(self.directory, name, _META)
            if os.path.isfile(path):
                try:
                    with open(path) as f:
                        return json.load(f)
                except (OSError, json.JSONDecodeError):
                    continue
        return None

    def metadata(self, step: int) -> dict[str, Any]:
        path = os.path.join(self.directory, f"{_PREFIX}{step:010d}", _META)
        with open(path) as f:
            return json.load(f)

    # ---- retention ----

    def _prune(self) -> None:
        for old in self.steps()[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(
                self.directory, f"{_PREFIX}{old:010d}"), ignore_errors=True)
            log.debug("pruned checkpoint step=%d", old)
        # Tmp dirs whose pid could not be parsed are collected by age.
        for name in os.listdir(self.directory):
            full = os.path.join(self.directory, name)
            if name.startswith("tmp-") and not is_foreign(full):
                try:
                    stale = time.time() - os.path.getmtime(full) > 3600
                except OSError:
                    continue
                if stale:
                    shutil.rmtree(full, ignore_errors=True)
