"""Build the package's CUDA sources at first use and load them with ctypes.

Each source under ``sharetrade_tpu_torch/csrc/`` is compiled on its own by
``nvcc`` into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o _build/<name>-<hash>.so csrc/<name>.cu

and loaded with :mod:`ctypes` (no PyTorch headers, so a build takes seconds).
Libraries land in ``sharetrade_tpu_torch/_build/`` (git-ignored), named by a
hash of the source, every shared header (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and an unchanged one is reused. The
compiler's log (``-Xptxas -v``: registers, spills and static shared memory
per kernel) is kept beside the library, and :func:`kernel_resources` reads
it. Nothing is built when a module is imported: the
first launch of a kernel builds it, and :func:`build_all` builds every source
at once, one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``. Raises when none exists."""
    candidates = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            candidates.append(os.path.join(os.environ[env], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin):"
        " the CUDA kernels of sharetrade_tpu_torch are built from source at "
        "first use and need the CUDA toolkit")


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))


def _library_path(name: str) -> str:
    """``_build/<name>-<hash>.so``: the hash covers ``<name>.cu``, every
    ``csrc/*.cuh`` (any source may include any header) and the flags."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for fname in [f"{name}.cu"] + headers:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            digest.update(fname.encode() + b"\0" + f.read() + b"\0")
    digest.update(" ".join(ARCH_FLAGS + CFLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str) -> tuple[subprocess.Popen, str, str] | None:
    """Start ``nvcc`` for one source unless its library is already built;
    returns (process, temporary output, final path)."""
    out = _library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, *CFLAGS, "-o", tmp,
           os.path.join(CSRC_DIR, f"{name}.cu")]
    # nvcc runs beside its siblings; _finish_build waits for it.
    proc = subprocess.Popen(  # actor-spawn-ok: waited for by _finish_build
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    with open(f"{tmp}.log", "w") as f:
        f.write(log)
    os.replace(f"{tmp}.log", f"{out[:-3]}.log")
    os.replace(tmp, out)      # atomic: a concurrent build sees all or none


def build_all() -> dict[str, float]:
    """Build every source in parallel; returns seconds spent per source
    (0.0 for one already built)."""
    t0 = time.perf_counter()
    with _lock:
        started = {name: _start_build(name) for name in sources()}
        timings = {}
        for name, job in started.items():
            if job is not None:
                _finish_build(name, job)
            timings[name] = (time.perf_counter() - t0) if job else 0.0
    return timings


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            job = _start_build(name)
            if job is not None:
                _finish_build(name, job)
            lib = ctypes.CDLL(_library_path(name))
            _loaded[name] = lib
    return lib


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(log: str) -> dict[str, dict]:
    """Per kernel (mangled name) in a ``-Xptxas -v`` log: ``registers``,
    ``spill_stores`` and ``spill_loads`` (bytes), ``stack`` (bytes) and
    ``static_smem`` (bytes; dynamic shared memory is set at launch)."""
    kernels: dict[str, dict] = {}
    current = None
    for line in log.splitlines():
        if m := _ENTRY.search(line):
            current = kernels.setdefault(m.group(1), {})
        elif current is None:
            continue
        elif m := _FRAME.search(line):
            current.update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        elif m := _USED.search(line):
            current["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            current["static_smem"] = int(s.group(1)) if s else 0
    return kernels


def kernel_resources(name: str) -> dict[str, dict]:
    """:func:`parse_ptxas` of ``csrc/<name>.cu``'s build log, read from
    beside its built library ({} if it was built before logs were kept)."""
    log = _library_path(name)[:-3] + ".log"
    if not os.path.exists(log):
        return {}
    with open(log) as f:
        return parse_ptxas(f.read())
