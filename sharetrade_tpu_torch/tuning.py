"""Self-tuning runtime: the knob registry and the per-host tuned profile.

The port's counterpart of the JAX package's ``tuning.py``, with the same
registry, the same file layout (``PROFILE_SCHEMA_VERSION``) and the same
precedence, so each package's :func:`load_profile` reads the other's
profile:

- **KNOBS**: the registry of tunable performance knobs (dotted config
  path, tier ``train`` / ``serve`` / ``distrib``, type).
- **tuned profile**: ``tools/torch_autotune.py`` sweeps the registry's
  knobs with a seeded successive-halving search over short measured
  windows and writes a schema-versioned, per-host ``tuned_profile.json``
  (atomic rename; host fingerprint: cores, backend, device count).
  ``cli train`` / ``cli serve`` load it through ``tuning.profile``.
- **precedence**: EXPLICIT config always wins over the profile, the
  profile over the defaults (:func:`apply_profile`); a knob counts as
  explicit when its value differs from the dataclass default or when
  ``--set`` named it. :func:`describe` gives each knob's provenance.
- **fingerprint contract**: a profile measured on another host shape
  (cores / backend / device count) is refused loudly
  (:class:`ProfileError`) unless ``tuning.allow_fingerprint_mismatch``.
  The backend is ``"gpu"`` with a CUDA device and ``"cpu"`` without one
  (the JAX package's names for those backends); the card's name rides
  along and never gates.

The online half lives in ``serve/controller.py``: it adapts
``serve.batch_timeout_ms`` / ``serve.max_queue`` below their configured
values against the engine's windowed latency histogram.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any

from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig
from sharetrade_tpu_torch.utils.logging import get_logger

log = get_logger("tuning")

#: Version of the tuned-profile schema. Bump on layout changes; a
#: mismatched profile is refused loudly (never best-effort-parsed: a
#: half-understood profile silently mis-tunes every run that loads it).
PROFILE_SCHEMA_VERSION = 1


class ProfileError(ConfigError):
    """A tuned profile that must not be applied: unreadable, wrong
    schema version, unknown knobs, or a host-fingerprint mismatch.
    Subclasses :class:`ConfigError` so the supervision decider maps it to
    STOP — re-running cannot make a foreign profile fit this host."""


@dataclass(frozen=True)
class Knob:
    """One registered tunable: the dotted config path is its identity
    (the profile file's key)."""

    path: str           # dotted config path, e.g. "serve.batch_timeout_ms"
    tier: str           # "train" | "serve" | "distrib"
    kind: type          # int | float
    description: str


#: THE registry (the JAX package's, path for path, in its order).
KNOBS: tuple[Knob, ...] = (
    Knob("runtime.megachunk_factor", "train", int,
         "chunks fused into one jitted program (dispatch-floor lever)"),
    Knob("runtime.pipeline_depth", "train", int,
         "async-readback boundaries in flight (HBM vs stall tradeoff)"),
    Knob("serve.max_batch", "serve", int,
         "padded device batch per serving tick"),
    Knob("serve.batch_timeout_ms", "serve", float,
         "partial-batch coalescing deadline"),
    Knob("serve.max_queue", "serve", int,
         "bounded ingress depth (queueing-delay vs shed-rate tradeoff)"),
    Knob("distrib.ingest_every_updates", "distrib", int,
         "learner-ingest cadence over the actor feeds"),
    Knob("distrib.ingest_max_rows", "distrib", int,
         "per-tick per-actor ingest row bound (0 = replay capacity)"),
)

_KNOBS_BY_PATH = {k.path: k for k in KNOBS}

#: Fingerprint fields that must MATCH for a profile to apply: a sweep
#: tuned for 2 cores or a TPU backend is wrong (not just stale) on any
#: other shape. Informational fields (machine, hostname, the card's name)
#: ride along in the profile but never gate.
_FINGERPRINT_MATCH_KEYS = ("cpu_count", "backend", "device_count")


def host_fingerprint(device: str | None = None) -> dict:
    """This host's identity as the autotuner sees it: ``backend`` is
    ``"gpu"`` when CUDA is available (``device_count`` its devices) and
    ``"cpu"`` otherwise (``device_count`` 1); ``device_name`` is the first
    card's name (None on the CPU), informational only. ``device`` names
    the device a sweep actually ran on, so a ``--device cpu`` sweep on a
    GPU host is fingerprinted ``"cpu"``."""
    import platform

    import torch
    if device is None:
        on_gpu = torch.cuda.is_available()
    else:
        on_gpu = torch.device(device).type == "cuda"
    if on_gpu:
        backend, device_count = "gpu", torch.cuda.device_count()
        device_name = torch.cuda.get_device_name(0)
    else:
        backend, device_count, device_name = "cpu", 1, None
    return {
        "cpu_count": os.cpu_count(),
        "backend": backend,
        "device_count": device_count,
        "device_name": device_name,
        "machine": platform.machine(),
        "hostname": platform.node(),
    }


def get_knob(cfg: FrameworkConfig, path: str) -> Any:
    """Read a dotted knob off a config tree."""
    target: Any = cfg
    for part in path.split("."):
        target = getattr(target, part)
    return target


def set_knob(cfg: FrameworkConfig, path: str, value: Any) -> None:
    """Write a dotted knob into a config tree (in place)."""
    *sections, leaf = path.split(".")
    target: Any = cfg
    for part in sections:
        target = getattr(target, part)
    setattr(target, leaf, value)


def knob_vector(cfg: FrameworkConfig) -> dict[str, Any]:
    """The RESOLVED value of every registered knob: what a run actually
    executed under."""
    return {k.path: get_knob(cfg, k.path) for k in KNOBS}


_DEFAULTS: dict[str, Any] | None = None


def default_knob_values() -> dict[str, Any]:
    """Registry knob values of a pristine :class:`FrameworkConfig` — the
    baseline the explicit-vs-default precedence test compares against."""
    global _DEFAULTS
    if _DEFAULTS is None:
        _DEFAULTS = knob_vector(FrameworkConfig())
    return dict(_DEFAULTS)


# ---------------------------------------------------------------------------
# profile file IO
# ---------------------------------------------------------------------------


def build_profile(knobs: dict[str, Any], *, objectives: dict | None = None,
                  trials: list | None = None, seed: int | None = None,
                  config_hash: str | None = None,
                  notes: str | None = None,
                  device: str | None = None) -> dict:
    """Assemble a profile document (the autotuner's output). ``knobs``
    keys must be registered dotted paths — a typo'd knob must fail at
    WRITE time, where the author is watching, not at every later load.
    ``device`` is the device the sweep ran on (see
    :func:`host_fingerprint`)."""
    unknown = sorted(set(knobs) - set(_KNOBS_BY_PATH))
    if unknown:
        raise ProfileError(
            f"unregistered knob(s) {unknown}; the registry "
            f"(tuning.py KNOBS) is the contract")
    coerced = {}
    for path, value in knobs.items():
        coerced[path] = _KNOBS_BY_PATH[path].kind(value)
    doc = {
        "schema_version": PROFILE_SCHEMA_VERSION,
        "fingerprint": host_fingerprint(device),
        "knobs": coerced,
    }
    if objectives:
        doc["objectives"] = objectives
    if trials:
        doc["trials"] = trials
    if seed is not None:
        doc["seed"] = seed
    if config_hash:
        doc["config_hash"] = config_hash
    if notes:
        doc["notes"] = notes
    return doc


def write_profile(path: str, profile: dict) -> dict:
    """Atomically publish a profile document (tmp + rename: a crashed
    sweep must never leave a torn profile a later run would half-parse).
    No fsync: a profile lost to a power cut re-tunes; a torn one would
    mis-tune."""
    if profile.get("schema_version") != PROFILE_SCHEMA_VERSION:
        raise ProfileError(
            f"refusing to write schema_version="
            f"{profile.get('schema_version')!r} (writer is "
            f"{PROFILE_SCHEMA_VERSION})")
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(profile, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return profile


def load_profile(path: str) -> dict:
    """Read + validate a tuned profile. Loud on every failure mode: a
    missing/torn/mis-versioned/unknown-knob profile raises
    :class:`ProfileError` instead of degrading to defaults silently —
    an operator who POINTED at a profile wants to know it didn't load."""
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
    except FileNotFoundError:
        raise ProfileError(f"tuned profile not found: {path}") from None
    except (OSError, json.JSONDecodeError) as exc:
        raise ProfileError(f"tuned profile {path} unreadable: {exc}") from exc
    if not isinstance(doc, dict) or "knobs" not in doc:
        raise ProfileError(f"tuned profile {path} has no 'knobs' object")
    if doc.get("schema_version") != PROFILE_SCHEMA_VERSION:
        raise ProfileError(
            f"tuned profile {path} schema_version="
            f"{doc.get('schema_version')!r} != {PROFILE_SCHEMA_VERSION}; "
            "re-run tools/torch_autotune.py")
    unknown = sorted(set(doc["knobs"]) - set(_KNOBS_BY_PATH))
    if unknown:
        raise ProfileError(
            f"tuned profile {path} carries unregistered knob(s) {unknown}")
    return doc


def fingerprint_mismatches(profile_fp: dict | None,
                           fp: dict | None = None) -> list[str]:
    """Which gating fingerprint fields disagree between a profile and
    this host (empty = the profile applies here)."""
    if not isinstance(profile_fp, dict):
        return list(_FINGERPRINT_MATCH_KEYS)
    fp = fp or host_fingerprint()
    return [k for k in _FINGERPRINT_MATCH_KEYS
            if profile_fp.get(k) != fp.get(k)]


# ---------------------------------------------------------------------------
# precedence: explicit config > profile > default
# ---------------------------------------------------------------------------


def apply_profile(cfg: FrameworkConfig, *, path: str | None = None
                  ) -> FrameworkConfig:
    """Resolve the config's registered knobs against its tuned profile.

    No-op (returns ``cfg`` unchanged) when ``tuning.profile`` is unset.
    Otherwise returns a NEW config where every registry knob still at its
    dataclass default takes the profile's value; knobs the operator set
    explicitly are untouched — explicit config always wins. "Explicit"
    means: the value differs from the dataclass default, OR the dotted
    path was applied through ``apply_overrides`` (its
    ``_explicit_overrides`` memo — so ``--set serve.max_queue=1024``
    pins the knob even when 1024 IS the default). The one remaining
    blind spot: a config FILE carrying a knob at its default value reads
    as default (file loading keeps no explicitness memo). Idempotent:
    re-applying sees the profile values as "explicit" and changes
    nothing, so cli bootstrap and the Orchestrator can both call it
    safely.

    Raises :class:`ProfileError` on a missing/invalid profile or a
    host-fingerprint mismatch (``tuning.allow_fingerprint_mismatch``
    downgrades the mismatch to a warning — for deliberately shipping one
    host's profile to a fleet of identical-enough machines)."""
    path = path if path is not None else getattr(cfg.tuning, "profile", None)
    if not path:
        return cfg
    profile = load_profile(path)
    mismatches = fingerprint_mismatches(profile.get("fingerprint"))
    if mismatches:
        fp = host_fingerprint()
        detail = ", ".join(
            f"{k}: profile={profile.get('fingerprint', {}).get(k)!r} "
            f"host={fp.get(k)!r}" for k in mismatches)
        if not cfg.tuning.allow_fingerprint_mismatch:
            raise ProfileError(
                f"tuned profile {path} was measured on a different host "
                f"shape ({detail}); re-run tools/torch_autotune.py here, "
                "or set tuning.allow_fingerprint_mismatch=true to apply it "
                "anyway")
        log.warning("applying tuned profile %s despite fingerprint "
                    "mismatch (%s): tuning.allow_fingerprint_mismatch",
                    path, detail)
    defaults = default_knob_values()
    explicit = frozenset(getattr(cfg, "_explicit_overrides", ()))
    new = FrameworkConfig.from_dict(cfg.to_dict())
    new._explicit_overrides = explicit      # survives re-application
    applied: dict[str, Any] = {}
    for kpath, value in profile["knobs"].items():
        if kpath in explicit or get_knob(cfg, kpath) != defaults[kpath]:
            continue            # explicit config wins
        value = _KNOBS_BY_PATH[kpath].kind(value)
        set_knob(new, kpath, value)
        applied[kpath] = value
    if applied:
        log.info("tuned profile %s applied: %s", path,
                 ", ".join(f"{k}={v}" for k, v in sorted(applied.items())))
    return new


def describe(cfg: FrameworkConfig) -> dict:
    """Provenance of every registered knob under ``cfg`` (``explicit``,
    ``profile`` or ``default``).

    Deterministic re-derivation (no hidden state): re-loads the profile
    named by the config and recomputes the same precedence
    :func:`apply_profile` used. Best-effort on the profile read (a
    profile gone missing after start-up is recorded, not raised)."""
    defaults = default_knob_values()
    path = getattr(cfg.tuning, "profile", None)
    profile_knobs: dict[str, Any] = {}
    out: dict[str, Any] = {
        "profile": path,
        "fingerprint": host_fingerprint(),
    }
    if path:
        try:
            profile = load_profile(path)
            profile_knobs = profile["knobs"]
            out["profile_fingerprint"] = profile.get("fingerprint")
            out["profile_mismatches"] = fingerprint_mismatches(
                profile.get("fingerprint"))
        except ProfileError as exc:
            out["profile_error"] = str(exc)
    explicit = frozenset(getattr(cfg, "_explicit_overrides", ()))
    knobs: dict[str, dict] = {}
    for knob in KNOBS:
        value = get_knob(cfg, knob.path)
        if knob.path in explicit:
            source = "explicit"     # a --set pin, even at default value
        elif value != defaults[knob.path]:
            source = ("profile"
                      if (knob.path in profile_knobs
                          and knob.kind(profile_knobs[knob.path]) == value)
                      else "explicit")
        else:
            source = "default"
        knobs[knob.path] = {
            "value": value,
            "default": defaults[knob.path],
            "source": source,
            "tier": knob.tier,
        }
    out["knobs"] = knobs
    return out
