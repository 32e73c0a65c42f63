"""The port stands alone: no JAX, nothing of the JAX package, no silent CPU.

- Importing the port's modules in a fresh interpreter leaves ``jax`` and
  ``sharetrade_tpu`` out of ``sys.modules``.
- A source scan of the package (its ``checkpoint/``, ``obs/``,
  ``tuning.py``, ``serve/controller.py`` and ``utils/flops.py`` included),
  ``chip_smoke.py`` and ``tools/torch_*.py`` finds no import of ``jax``, ``flax``, ``optax`` or
  ``msgpack`` (the machine with the card has none of them), no reference
  to the JAX package's modules, and no ``-m sharetrade_tpu.<module>``
  string a child process would run (an actor or engine pool spawning the
  JAX package's CLI).
- Without a GPU and without ``--device cpu``, ``cli serve``, ``cli train``
  and ``cli fleet`` fail with a message that says so instead of running on
  the CPU.
- What the fleet does not port is refused with exit code 2 and a message
  naming its ROADMAP item: ``obs.enabled`` with ``cli serve --listen``,
  ``cli fleet`` or ``cli fleet --learner`` (item 13).
- The repo's network, spawn and native-wire lints
  (``tools/lint_hot_loop.py`` checks 12, 14, 15 and 18) find nothing in the
  port but lines carrying the JAX package's own markers.
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
#: A child's module argument naming the JAX package: ``-m sharetrade_tpu.x``
#: on a command line, or ``"-m", "sharetrade_tpu.x"`` in an argv list.
_JAX_MODULE_ARG = re.compile(
    r"""-m["']?\s*,?\s*["']?sharetrade_tpu(\.|["'\s]|$)""")


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
                 PACKAGE / "utils" / "flops.py",
                 REPO / "tools" / "torch_train_ab.py",
                 REPO / "tools" / "torch_autotune.py"):
        assert path in files, path
    for rel in FLEET_MODULES + ACTOR_MODULES:
        assert PACKAGE / rel in files, rel
    return files


#: The fleet slice's modules: the source scan and the import check must
#: cover each of them.
FLEET_MODULES = (
    "distrib/__init__.py", "distrib/ladder.py", "obs/exporter.py",
    "obs/tsdb.py", "obs/trace.py", "fleet/__init__.py", "fleet/proto.py",
    "fleet/wire.py", "fleet/frontend.py", "fleet/evloop.py",
    "fleet/router.py", "fleet/pool.py", "fleet/loadgen.py",
    "fleet/autoscale.py")
#: The actor slice's modules.
ACTOR_MODULES = ("distrib/actor.py", "distrib/pool.py", "fleet/flywheel.py")


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


@pytest.mark.parametrize("pattern", [_JAX_IMPORT, _JAX_PACKAGE,
                                     _JAX_MODULE_ARG],
                         ids=["jax-import", "jax-package", "jax-module-arg"])
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


def test_cli_fleet_without_gpu_refuses_instead_of_running_on_cpu(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "sharetrade_tpu_torch.cli", "fleet",
         "--engines", "1", "--duration", "1"], capture_output=True,
        text=True, timeout=120, cwd=tmp_path, env=_env(CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 2
    assert "CUDA" in out.stderr and "--device cpu" in out.stderr
    assert "fleet_ready" not in out.stdout
    assert not (tmp_path / "fleet").exists()     # no worker was spawned


@pytest.mark.parametrize("argv,item", [
    (["fleet", "--learner", "--device", "cpu", "--set", "learner.algo=dqn",
      "--set", "obs.enabled=true"], "ROADMAP item 13"),
    (["fleet", "--device", "cpu", "--set", "obs.enabled=true"],
     "ROADMAP item 13"),
    (["serve", "--listen", "127.0.0.1:0", "--device", "cpu", "--set",
      "obs.enabled=true"], "ROADMAP item 13"),
], ids=["fleet-learner", "fleet-obs", "listen-obs"])
def test_unported_fleet_parts_are_refused(argv, item, capsys, tmp_path,
                                          monkeypatch):
    from sharetrade_tpu_torch import cli
    monkeypatch.chdir(tmp_path)
    assert cli.main(argv) == 2
    err = capsys.readouterr().err
    assert "ConfigError" in err and item in err
    assert not (tmp_path / "fleet").exists()


def test_network_spawn_and_native_wire_lints_pass_on_the_port():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import lint_hot_loop as lint
    finally:
        sys.path.remove(str(REPO / "tools"))
    listeners, _ = lint.lint_fleet_net(PACKAGE)
    assert listeners == []
    assert lint.lint_evloop_sansio(PACKAGE) == ([], [])
    spawns, _ = lint.lint_actor_spawn(PACKAGE)
    assert spawns == []
    assert lint.lint_native_wire(PACKAGE) == ([], [], [])
    # The scans saw the fleet's files: its spawn and listener lines carry
    # the JAX package's markers.
    pool = (PACKAGE / "fleet" / "pool.py").read_text()
    assert lint.ACTOR_SPAWN_MARKER in pool and "subprocess.Popen(" in pool
    assert (PACKAGE / "fleet" / "proto.py").exists()


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


def test_the_module_arg_pattern_catches_a_jax_child():
    """The scan's pattern flags a JAX child command in either spelling and
    passes the port's own."""
    for line in ('cmd = [sys.executable, "-m", "sharetrade_tpu.cli", "actor"]',
                 "python -m sharetrade_tpu.cli learner",
                 "cmd = ['-m', 'sharetrade_tpu']"):
        assert _JAX_MODULE_ARG.search(line), line
    for line in ('cmd = [sys.executable, "-m", "sharetrade_tpu_torch.cli"]',
                 "python -m sharetrade_tpu_torch.cli actor"):
        assert not _JAX_MODULE_ARG.search(line), line


@pytest.mark.parametrize("module", FLEET_MODULES + ACTOR_MODULES)
def test_the_fleet_modules_are_scanned_and_imported(module):
    """The fleet slice's modules are among the files the source scan reads
    and the modules the import check imports (both walk the package)."""
    path = PACKAGE / module
    assert path.exists() and path in _sources()
    assert path in sorted(PACKAGE.rglob("*.py"))
