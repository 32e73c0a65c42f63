"""Packed binary transition records for the replay journal.

A copy of the JAX package's ``data/transitions.py`` with its own imports,
numpy readers only (the JAX package reads the tail through its C++ library
when that is built; both give the same arrays). DQN's journal-backed
replay (``learner.journal_replay``) stores each chunk's transitions as
packed little-endian arrays inside the CRC-framed journal records
(``data/journal.py``), so recovery is one buffer copy per record.

Payload layout (the JAX package's and its native journal's, byte for byte):

    "STR1" | u32 batch | u32 obs_dim | u64 env_steps |
    f32 obs[batch*obs_dim] | i32 action[batch] | f32 reward[batch] |
    f32 next_obs[batch*obs_dim]
"""

from __future__ import annotations

import os
import struct

import numpy as np

from sharetrade_tpu_torch.data.journal import iter_framed_records

MAGIC = b"STR1"
_HEAD = struct.Struct("<4sIIQ")           # magic, batch, obs_dim, env_steps


def encode_transitions(obs, action, reward, next_obs,
                       env_steps: int = 0) -> bytes:
    """Pack one batch of transitions into a journal payload."""
    obs = np.ascontiguousarray(obs, np.float32)
    next_obs = np.ascontiguousarray(next_obs, np.float32)
    action = np.ascontiguousarray(action, np.int32)
    reward = np.ascontiguousarray(reward, np.float32)
    batch, obs_dim = obs.shape
    if next_obs.shape != (batch, obs_dim) or action.shape != (batch,) \
            or reward.shape != (batch,):
        raise ValueError(
            f"inconsistent transition shapes: obs {obs.shape}, "
            f"next_obs {next_obs.shape}, action {action.shape}, "
            f"reward {reward.shape}")
    return b"".join([
        _HEAD.pack(MAGIC, batch, obs_dim, env_steps),
        obs.tobytes(), action.tobytes(), reward.tobytes(),
        next_obs.tobytes(),
    ])


def peek_transitions_header(payload: bytes):
    """``(batch, obs_dim, env_steps)`` from a transition payload WITHOUT
    materializing the arrays — same well-formedness checks as
    :func:`decode_transitions` (a record the peek accepts, decode
    accepts). The ingest reader's steady no-new-rows tick rides this:
    stamping out old records must not cost a full array decode."""
    if len(payload) < _HEAD.size or payload[:4] != MAGIC:
        return None
    _magic, batch, obs_dim, env_steps = _HEAD.unpack_from(payload)
    if len(payload) != _HEAD.size + (obs_dim * 8 + 8) * batch:
        return None
    return batch, obs_dim, env_steps


def decode_transitions(payload: bytes):
    """Inverse of :func:`encode_transitions`.

    Returns ``(obs, action, reward, next_obs, env_steps)`` or ``None`` when
    the payload is not a (well-formed) transition record."""
    if len(payload) < _HEAD.size or payload[:4] != MAGIC:
        return None
    magic, batch, obs_dim, env_steps = _HEAD.unpack_from(payload)
    row_bytes = obs_dim * 8 + 8
    if len(payload) != _HEAD.size + row_bytes * batch:
        return None
    ob = batch * obs_dim * 4
    o = _HEAD.size
    obs = np.frombuffer(payload, np.float32, batch * obs_dim, o).reshape(
        batch, obs_dim)
    action = np.frombuffer(payload, np.int32, batch, o + ob)
    reward = np.frombuffer(payload, np.float32, batch, o + ob + batch * 4)
    next_obs = np.frombuffer(payload, np.float32, batch * obs_dim,
                             o + ob + batch * 8).reshape(batch, obs_dim)
    return obs, action, reward, next_obs, env_steps


def append_transitions(journal, obs, action, reward, next_obs,
                       env_steps: int = 0) -> None:
    """Append one packed transition record through either journal backend."""
    journal.append_bytes(
        encode_transitions(obs, action, reward, next_obs, env_steps))


def read_tail_transitions(path: str, max_rows: int, *,
                          cutoff_env_steps: int = 0, journal=None):
    """Read the journal's recovery tail: the most recent records covering at
    most ``max_rows`` rows, skipping records with env_steps beyond
    ``cutoff_env_steps`` (0 = no cutoff), oldest-first so circular-buffer
    "newest wins" pushes are deterministic.

    ``journal`` (optional): the live journal object backing ``path``; when
    given it is quiesced first (``flush()``) so appends still buffered by a
    group-commit batch are visible to the tail walk
    — reading the path under a live buffering writer would silently treat
    the buffered tail as not-yet-written.

    Returns ``(obs, action, reward, next_obs, high_water)`` — high_water is
    the max env_steps over ALL intact transition records (the resume-time
    double-journaling guard) — or ``None`` when no transition records exist.
    When the cutoff excludes every record the arrays come back with zero
    rows but high_water is still recovered (losing it would re-journal the
    excluded chunks with duplicate stamps and double-fill the next recovery).
    """
    flush = getattr(journal, "flush", None)
    if flush is not None:
        flush()
    from sharetrade_tpu_torch.data.journal import segment_paths
    seals = segment_paths(path)
    if not seals:
        return _read_tail_paths([path], max_rows, cutoff_env_steps)
    # Segmented journal (data.journal_segment_records): walk the TAIL
    # segments only — newest first, stopping once the kept rows cover
    # max_rows — instead of scanning the whole history. env_steps
    # stamps are monotone in append order (the orchestrator's
    # high-water guard), so the high-water mark recovered from the
    # scanned tail IS the global one. The snapshot must be STABLE
    # across the walk: a LIVE writer rotating between the listing and
    # the active-file read seals a segment this walk never visits, and
    # the recovered high-water regresses (observed as a negative
    # high-water delta in the scaling bench) — re-list and retry until
    # the segment set held still.
    for _ in range(6):
        out = _read_tail_paths([*seals, path], max_rows, cutoff_env_steps)
        reseals = segment_paths(path)
        if reseals == seals:
            return out
        seals = reseals
    # Rotation outpaced every snapshot (a pathologically fast writer);
    # recovery callers read quiescent journals, so serve the last walk.
    return out


def _read_tail_paths(paths, max_rows, cutoff):
    """Tail walk over an ordered (oldest-first) list of journal files:
    files are scanned newest-first and each is decoded whole, but the walk
    stops descending into OLDER files once the kept records cover
    ``max_rows`` — the bounded-recovery property segmentation buys. The
    high-water mark covers every scanned record (== the global maximum
    when stamps are monotone in append order, which the journaling
    high-water guard enforces)."""
    kept, rows, obs_dim, high_water = [], 0, None, 0
    seen_any = False
    for path in reversed(paths):          # newest file first
        recs = []
        try:
            for _offset, payload in iter_framed_records(path):
                decoded = decode_transitions(payload)
                if decoded is not None:
                    recs.append(decoded)
        except FileNotFoundError:
            # Rotation race on a LIVE writer's journal (the soak's
            # high-water probe reads under a rolling-out actor): the
            # active file was sealed-and-recreated between the existence
            # check and the open; its rows are in the newest sealed
            # segment, which this walk reads next.
            continue
        if recs:
            seen_any = True
            high_water = max(high_water, max(r[4] for r in recs))
            if obs_dim is None:
                obs_dim = recs[-1][0].shape[1]
        satisfied = False
        for rec in reversed(recs):
            if cutoff and rec[4] > cutoff:
                continue
            if rec[0].shape[1] != obs_dim:
                continue
            kept.append(rec)
            rows += rec[0].shape[0]
            if max_rows and rows >= max_rows:
                satisfied = True
                break
        if satisfied:
            break
    if not seen_any:
        return None
    if not kept:
        # Every record excluded by the cutoff: the high-water mark (the
        # double-journaling guard) must still come back — zero rows, not None.
        return (np.zeros((0, obs_dim), np.float32),
                np.zeros((0,), np.int32), np.zeros((0,), np.float32),
                np.zeros((0, obs_dim), np.float32), high_water)
    kept.reverse()                        # oldest-first
    obs = np.concatenate([r[0] for r in kept])
    action = np.concatenate([r[1] for r in kept])
    reward = np.concatenate([r[2] for r in kept])
    next_obs = np.concatenate([r[3] for r in kept])
    return obs, action, reward, next_obs, high_water


def read_new_transitions(path: str, floor_env_steps: int, max_rows: int):
    """The learner-side INGEST read (actor/learner disaggregation): the
    records with ``env_steps`` stamps STRICTLY ABOVE ``floor_env_steps`` —
    the complement of :func:`read_tail_transitions`'s resume cutoff. The
    learner keeps a per-actor cursor (the last stamp it ingested) and each
    ingest tick consumes exactly the rows the actor committed since.

    Stamps are monotone in append order (each actor stamps its own
    monotone env-step counter, recovered across its own restarts from the
    journal high-water), so the walk is bounded the same way the recovery
    tail is: files are scanned newest-first and the descent stops at the
    first file whose newest record is already at or below the floor —
    older files cannot hold newer stamps. ``max_rows`` caps the kept rows
    at whole-record granularity, keeping the OLDEST above-floor records
    so the backlog streams across ticks; the returned high-water is the
    max stamp over the KEPT records (the scanned tail when nothing was
    capped), so advancing the cursor to it never skips a committed row —
    capped-out newer rows are simply next tick's read. Returns
    ``(obs, action, reward, next_obs, high_water)`` or ``None`` when no
    transition records exist.

    The segment snapshot must hold STILL across the walk: the actor
    rotating between the listing and the active-file read seals a
    segment the walk never visits while the NEW active file may already
    hold higher stamps — advancing the cursor to them would skip the
    sealed rows forever. Re-list and retry; if the set never stabilizes,
    report nothing new (high-water == floor) so the next tick retries
    rather than skip."""
    from sharetrade_tpu_torch.data.journal import segment_paths
    seals = segment_paths(path)
    for _ in range(6):
        out = _read_new_paths([*seals, path], floor_env_steps, max_rows)
        reseals = segment_paths(path)
        if reseals == seals:
            return out
        seals = reseals
    if out is None:
        return None
    obs_dim = out[0].shape[1]
    return (np.zeros((0, obs_dim), np.float32),
            np.zeros((0,), np.int32), np.zeros((0,), np.float32),
            np.zeros((0, obs_dim), np.float32), floor_env_steps)


def _read_new_paths(paths, floor_env_steps, max_rows):
    kept, rows, obs_dim, high_water = [], 0, None, 0
    seen_any = False
    for p in reversed(paths):             # newest file first
        # Header-only scan first: in the steady no-new-rows case (idle,
        # caught-up, or dead actor) every record stamps at or below the
        # floor, and a full array decode per record per ingest tick
        # would be pure waste — stamps live in the record header.
        heads = []
        try:
            for _offset, payload in iter_framed_records(p):
                head = peek_transitions_header(payload)
                if head is not None:
                    heads.append((head, payload))
        except FileNotFoundError:
            # Rotation race on a LIVE writer's journal: the active file
            # is renamed aside and re-created between our existence check
            # and the open. The caller's stable-snapshot retry re-walks
            # with the sealed segment included.
            continue
        if heads:
            seen_any = True
            high_water = max(high_water,
                             max(h[2] for h, _payload in heads))
            if obs_dim is None:
                obs_dim = heads[-1][0][1]
        satisfied = not heads and seen_any
        for (batch, rec_dim, stamp), payload in reversed(heads):
            if stamp <= floor_env_steps:
                # Monotone stamps: everything at or before this record —
                # in this file and in every older file — is already
                # ingested; the descent stops here.
                satisfied = True
                break
            if rec_dim != obs_dim:
                continue
            rec = decode_transitions(payload)
            if rec is None:               # peek-accepted implies decodes
                continue
            kept.append(rec)
            rows += batch
        if satisfied:
            # NOTE: a max_rows cap must NOT stop the descent — the
            # unscanned records are the OLDEST above-floor ones, exactly
            # the rows the cap keeps (see below).
            break
    if not seen_any:
        return None
    if not kept:
        return (np.zeros((0, obs_dim), np.float32),
                np.zeros((0,), np.int32), np.zeros((0,), np.float32),
                np.zeros((0, obs_dim), np.float32), high_water)
    kept.reverse()                        # oldest-first
    if max_rows and rows > max_rows:
        # Over-cap backlog: keep the OLDEST records up to the cap (whole
        # records — a stamp is per-record, so splitting one would make
        # the cursor ambiguous) and report the high-water of the KEPT
        # tail only. Keeping the newest instead would advance the cursor
        # past the dropped older rows and skip them FOREVER; this way
        # the next tick resumes exactly where this one stopped.
        capped, capped_rows = [], 0
        for rec in kept:
            if capped and capped_rows + rec[0].shape[0] > max_rows:
                break
            capped.append(rec)
            capped_rows += rec[0].shape[0]
        kept = capped
        high_water = max(r[4] for r in kept)
    obs = np.concatenate([r[0] for r in kept])
    action = np.concatenate([r[1] for r in kept])
    reward = np.concatenate([r[2] for r in kept])
    next_obs = np.concatenate([r[3] for r in kept])
    return obs, action, reward, next_obs, high_water


def count_transition_rows(path: str) -> int:
    """Transition rows in one journal file — header-only decode (magic +
    batch count), no array copies."""
    rows = 0
    for _offset, payload in iter_framed_records(path):
        if len(payload) >= _HEAD.size and payload[:4] == MAGIC:
            _magic, batch, _obs_dim, _steps = _HEAD.unpack_from(payload)
            rows += batch
    return rows


def retire_transition_segments(journal, keep_rows: int) -> tuple[int, int]:
    """Segment-granular compaction (``data.journal_segment_records``):
    delete sealed segments wholly OLDER than the newest ``keep_rows``
    transition rows — the replay-capacity horizon; nothing newer is ever
    touched, and the active segment never is. Work is bounded: counting
    stops at the first segment the newer tail already covers, and
    everything older is deleted by size alone. Returns
    ``(retired_segments, freed_bytes)``."""
    from sharetrade_tpu_torch.data.journal import _fsync_dir, segment_paths
    flush = getattr(journal, "flush", None)
    if flush is not None:
        flush()
    seals = segment_paths(journal.path)
    if not seals:
        return 0, 0
    covered = count_transition_rows(journal.path)   # active segment
    retired = freed = 0
    for i in range(len(seals) - 1, -1, -1):         # newest sealed first
        if covered >= keep_rows:
            for victim in seals[:i + 1]:
                freed += os.path.getsize(victim)
                os.remove(victim)
                retired += 1
            break
        covered += count_transition_rows(seals[i])
    if retired:
        _fsync_dir(journal.path)
    return retired, freed


def compact_transitions(journal, keep_rows: int) -> bool:
    """Drop journal records older than the tail covering ``keep_rows``
    transition rows (the replay buffer can't hold more anyway — the same
    bound read_tail_transitions applies on recovery).

    Record boundaries and per-record env_steps stamps are preserved
    verbatim, so the resume-time cutoff filtering stays exact after a
    compaction; non-transition payloads inside the kept tail are kept too.
    Returns True when anything was dropped. (The reference delegates this to
    LevelDB's per-actor compaction intervals, application.conf:7-14.)
    """
    # Async-writer journals buffer appends in a background thread; reading
    # journal.path without quiescing would compute the keep-boundary from a
    # stale snapshot and the rewrite would DROP the queued records.
    flush = getattr(journal, "flush", None)
    if flush is not None:
        flush()
    from sharetrade_tpu_torch.data.journal import segment_paths
    if segment_paths(journal.path):
        # Segmented journal: the rewrite below would compute its keep-set
        # from the ACTIVE file alone while compact_payloads deletes every
        # sealed segment — destroying the horizon this function promises
        # to keep. Segment-granular retirement IS this contract there.
        return retire_transition_segments(journal, keep_rows)[0] > 0
    payloads = [p for _off, p in iter_framed_records(journal.path)]
    rows = 0
    boundary = len(payloads)
    for i in range(len(payloads) - 1, -1, -1):
        decoded = decode_transitions(payloads[i])
        boundary = i
        if decoded is not None:
            rows += decoded[0].shape[0]
            if rows >= keep_rows:
                break
    if boundary == 0:
        return False
    journal.compact_payloads(payloads[boundary:])
    return True


