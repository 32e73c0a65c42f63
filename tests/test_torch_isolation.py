"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU.

- Importing the port's modules in a fresh interpreter leaves ``jax`` and
  ``sharetrade_tpu`` out of ``sys.modules``.
- A source scan of the package (its ``checkpoint/``, ``obs/``,
  ``tuning.py`` and ``serve/controller.py`` included),
  ``chip_smoke.py`` and ``tools/torch_*.py`` finds no import of ``jax``, ``flax``, ``optax`` or
  ``msgpack`` (the machine with the card has none of them) and no reference
  to the JAX package's modules.
- Without a GPU and without ``--device cpu``, ``cli serve`` and ``cli
  train`` fail with a message that says so instead of running on the CPU.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = REPO / "sharetrade_tpu_torch"

_JAX_IMPORT = re.compile(r"^\s*(import\s+(jax|jaxlib|flax|optax|msgpack)\b|"
                         r"from\s+(jax|jaxlib|flax|optax|msgpack)\b)", re.M)
_JAX_PACKAGE = re.compile(r"sharetrade_tpu\.|from\s+sharetrade_tpu\s|"
                          r"import\s+sharetrade_tpu\b(?!_)")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _sources():
    files = (sorted(PACKAGE.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "tools").glob("torch_*.py")))
    assert len(files) > 10
    for path in (PACKAGE / "checkpoint" / "manager.py",
                 PACKAGE / "obs" / "__init__.py", PACKAGE / "obs" / "hist.py",
                 PACKAGE / "tuning.py", PACKAGE / "serve" / "controller.py",
                 REPO / "tools" / "torch_train_ab.py",
                 REPO / "tools" / "torch_autotune.py"):
        assert path in files, path
    return files


def test_import_leaves_jax_and_the_jax_package_out(tmp_path):
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__") for p in PACKAGE.rglob("*.py"))
    code = ("import importlib, json, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'msgpack', "
            "'sharetrade_tpu')]\n"
            "print(json.dumps(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=tmp_path, env=_env())
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("pattern", [_JAX_IMPORT, _JAX_PACKAGE],
                         ids=["jax-import", "jax-package"])
def test_sources_reference_no_jax(pattern):
    hits = []
    for path in _sources():
        for n, line in enumerate(path.read_text().splitlines(), 1):
            if pattern.search(line):
                hits.append(f"{path.relative_to(REPO)}:{n}: {line.strip()}")
    assert hits == []


def test_cli_without_gpu_refuses_instead_of_running_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "sharetrade_tpu_torch.cli", "serve",
         "--duration", "1"], capture_output=True, text=True, timeout=120,
        cwd=tmp_path, env=_env(CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "--device cpu" in out.stderr
    assert "serving_ready" not in out.stdout


def test_cli_train_without_gpu_refuses_instead_of_running_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "sharetrade_tpu_torch.cli", "train",
         "--set", "data.synthetic_length=300"], capture_output=True,
        text=True, timeout=120, cwd=tmp_path, env=_env(CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert "CUDA" in out.stderr and "--device cpu" in out.stderr
    assert "avg_portfolio" not in out.stdout


def test_library_entry_points_default_to_cuda():
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the default is satisfiable")
    from sharetrade_tpu_torch.config import ModelConfig
    from sharetrade_tpu_torch.models import build_model
    with pytest.raises(RuntimeError, match="--device cpu"):
        build_model(ModelConfig(kind="transformer", seq_mode="episode"), 203)


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into an empty directory (no package beside it) the smoke
    script must fail and print no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"],
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env=env)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("module", [
    "parallel/__init__.py", "parallel/moe.py", "env/portfolio.py",
    "models/lstm.py", "models/tcn.py", "models/transformer.py"])
def test_the_policy_family_modules_are_scanned_and_imported(module):
    """The other policy families' modules are among the files the source
    scan reads and the modules the import check imports (both walk the
    package)."""
    path = PACKAGE / module
    assert path.exists() and path in _sources()
    assert path in sorted(PACKAGE.rglob("*.py"))
