"""Run manifest: the identity card every telemetry consumer needs first.

One ``manifest.json`` per run dir, written when the run's telemetry is
built: the full config plus a stable hash of it (so two run dirs are
comparable at a glance), the device backend the run actually got, and the
git revision of the code that produced the numbers. Everything is
best-effort — a missing git binary or a detached workdir must not block
training — and written atomically like every other obs artifact.

The counterpart of the JAX package's ``obs/manifest.py``. ``config.py`` is a
copy of the JAX schema, so :func:`config_hash` gives the JAX hash for the
same config. ``backend`` is ``"cuda"`` or ``"cpu"`` (the device the run
targets), ``device_count`` and ``device_name`` come from ``torch.cuda``,
and ``torch_version`` stands where the JAX manifest has ``jax_version``.
"""

from __future__ import annotations

import hashlib
import json
import os
import platform
import subprocess
import sys
import time
from typing import Any


def _git_rev() -> str | None:
    try:
        repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=repo_dir, timeout=5,
            capture_output=True, text=True)
        return out.stdout.strip() or None if out.returncode == 0 else None
    except Exception:
        return None


def config_hash(cfg: Any) -> str:
    """The stable 16-char config identity: sha256 of the config's sorted
    JSON, the JAX package's recipe."""
    blob = json.dumps(cfg.to_dict(), sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def _device_facts(device: Any) -> tuple[str, int, str | None]:
    """``(backend, device_count, device_name)`` of the device the run
    targets: ``device`` when given, else the card when there is one."""
    import torch
    if device is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
        index = 0
    else:
        dev = torch.device(device)
        kind, index = dev.type, dev.index or 0
    if kind == "cuda":
        return ("cuda", torch.cuda.device_count(),
                torch.cuda.get_device_name(index))
    return kind, 1, None


def build_manifest(cfg: Any, *, device: Any = None) -> dict:
    cfg_dict = cfg.to_dict()
    try:
        import torch
        backend, device_count, device_name = _device_facts(device)
        torch_version = torch.__version__
    except Exception:       # manifest must not force device discovery to work
        backend, device_count, device_name, torch_version = (
            None, None, None, None)
    manifest = {
        "created_at": time.time(),
        "config_hash": config_hash(cfg),
        "config": cfg_dict,
        "backend": backend,
        "device_count": device_count,
        "device_name": device_name,
        "mesh_shape": None,         # one device: no mesh in the port yet
        "git_rev": _git_rev(),
        "torch_version": torch_version,
        "python_version": sys.version.split()[0],
        "hostname": platform.node(),
        "pid": os.getpid(),
    }
    try:
        # Tuned-knob provenance (tuning.py): which registered knobs ran
        # at default / profile / explicit values, and under which
        # profile + host fingerprint — the ``cli obs`` tuning section's
        # source. Best-effort like the git probe: a vanished profile
        # must not block a run from writing its manifest.
        if hasattr(cfg, "tuning"):
            from sharetrade_tpu_torch.tuning import describe
            manifest["tuning"] = describe(cfg)
    except Exception:
        pass
    return manifest


def write_manifest(path: str, cfg: Any, *, device: Any = None) -> dict:
    manifest = build_manifest(cfg, device=device)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2, default=str)
    os.replace(tmp, path)
    return manifest
