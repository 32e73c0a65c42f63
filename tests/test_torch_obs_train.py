"""A training run with ``obs.enabled`` in the port against the same run in
the JAX package, on the CPU.

Both packages train the reference Q-network (window 8, 8 hidden units, two
agents, four 16-step chunks, every chunk read back, the pipeline off so the
span sequence is deterministic) from the same config, each from its own
directory, and a fault hook raises once at chunk 2, so each run also takes
one supervised restart from a checkpoint. Held equal between the two run
directories:

- the ``config_hash`` of the manifest (the port's ``config.py`` is a copy
  of the JAX schema), and each package's ``config_hash`` of the config;
- the set of span and instant names in ``trace.jsonl``;
- the count of ``chunk_metrics`` rows in the flight ring, and the bundle's
  reason (``supervision``) and failing chunk (2);
- the metric families of ``metrics.prom`` under the JAX package's strict
  ``parse_prom_text``, the ``train_chunk_seconds`` count among them;
- the sections each package's ``summarize_run_dir`` finds in either run
  directory, and ``cli obs --dir`` of the port on the JAX run.

With obs off the port creates no run directory. The port's manifest names
its backend (``cpu`` here) and its torch version.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from sharetrade_tpu.config import FrameworkConfig as JConfig
from sharetrade_tpu.obs import parse_prom_text
from sharetrade_tpu.obs import summarize_run_dir as jsummarize
from sharetrade_tpu.obs.manifest import config_hash as jconfig_hash
from sharetrade_tpu.runtime import Orchestrator as JOrchestrator
from sharetrade_tpu_torch import cli
from sharetrade_tpu_torch.config import FrameworkConfig
from sharetrade_tpu_torch.obs import summarize_run_dir
from sharetrade_tpu_torch.obs.manifest import config_hash
from sharetrade_tpu_torch.runtime import Orchestrator

WINDOW, CHUNK, CHUNKS = 8, 16, 4
FAULT_CHUNK = 2
SETS = [f"env.window={WINDOW}", "model.hidden_dim=8",
        f"runtime.chunk_steps={CHUNK}", "parallel.num_workers=2",
        "runtime.metrics_every_chunks=1", "runtime.async_pipeline=false",
        "runtime.checkpoint_every_updates=16",
        "runtime.backoff_initial_s=0.01", "runtime.backoff_max_s=0.02",
        "obs.enabled=true", "obs.dir=obs", "obs.export_interval_s=60",
        "runtime.checkpoint_dir=ckpt"]
PRICES = np.linspace(10.0, 20.0, WINDOW + CHUNK * CHUNKS, dtype=np.float32)


def _fault_once():
    fired = []

    def hook(chunk_idx, row):
        if chunk_idx == FAULT_CHUNK and not fired:
            fired.append(chunk_idx)
            raise RuntimeError("injected fault")
    return hook


def _train(pkg: str, root, monkeypatch, sets=SETS):
    run = root / pkg
    run.mkdir()
    monkeypatch.chdir(run)
    if pkg == "jax":
        cfg = JConfig().apply_overrides(sets)
        orch = JOrchestrator(cfg, fault_hook=_fault_once())
    else:
        cfg = FrameworkConfig().apply_overrides(sets)
        orch = Orchestrator(cfg, device="cpu", fault_hook=_fault_once())
    orch.send_training_data(PRICES)
    orch.start_training(background=False)
    orch.stop()
    assert orch.restarts == 1
    return cfg, run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("obs-train")
    mp = pytest.MonkeyPatch()
    try:
        out = {pkg: _train(pkg, root, mp) for pkg in ("jax", "torch")}
    finally:
        mp.undo()
    return {pkg: (cfg, str(run / "obs")) for pkg, (cfg, run) in out.items()}


def _names(run_dir: str) -> set[str]:
    from sharetrade_tpu.obs import read_trace
    return {ev["name"] for ev in read_trace(os.path.join(run_dir,
                                                         "trace.jsonl"))}


def test_manifests_name_the_same_config(runs):
    (jcfg, jdir), (tcfg, tdir) = runs["jax"], runs["torch"]
    manifests = {}
    for pkg, (_, run_dir) in runs.items():
        with open(os.path.join(run_dir, "manifest.json")) as f:
            manifests[pkg] = json.load(f)
    assert config_hash(tcfg) == jconfig_hash(jcfg) == \
        manifests["jax"]["config_hash"] == manifests["torch"]["config_hash"]
    assert manifests["torch"]["config"] == manifests["jax"]["config"]
    assert manifests["torch"]["backend"] == "cpu"
    assert manifests["torch"]["device_count"] == 1
    assert manifests["torch"]["torch_version"]
    assert "jax_version" not in manifests["torch"]
    assert set(manifests["torch"]["tuning"]["knobs"]) == \
        set(manifests["jax"]["tuning"]["knobs"])


def test_span_names_and_counts_match(runs):
    names = {pkg: _names(d) for pkg, (_, d) in runs.items()}
    assert names["torch"] == names["jax"]
    assert {"dispatch", "readback", "host_process", "checkpoint_save",
            "checkpoint_snapshot", "checkpoint_restore",
            "supervision_recovery", "phase:training",
            "phase:completed", "flight_recorder_dump"} <= names["torch"]


def test_flight_bundles_match(runs):
    bundles = {}
    for pkg, (_, run_dir) in runs.items():
        with open(os.path.join(run_dir, "flight_recorder.json")) as f:
            bundles[pkg] = json.load(f)
    for key in ("reason", "failing_chunk"):
        assert bundles["torch"][key] == bundles["jax"][key]
    assert bundles["torch"]["reason"] == "supervision"
    assert bundles["torch"]["failing_chunk"] == FAULT_CHUNK
    assert bundles["torch"]["context"]["next_chunk"] == \
        bundles["jax"]["context"]["next_chunk"]

    def chunk_rows(bundle):
        return sum(e["kind"] == "chunk_metrics" for e in bundle["events"])

    assert chunk_rows(bundles["torch"]) == chunk_rows(bundles["jax"]) > 0
    # Both packages log under "sharetrade": compare the ring by kind.
    kinds = {pkg: {e["kind"] for e in b["events"]}
             for pkg, b in bundles.items()}
    assert kinds["torch"] == kinds["jax"]


def test_metric_families_match(runs):
    prom = {}
    for pkg, (_, run_dir) in runs.items():
        with open(os.path.join(run_dir, "metrics.prom")) as f:
            prom[pkg] = parse_prom_text(f.read())
    for section in ("gauges", "counters", "histograms"):
        assert set(prom["torch"][section]) == set(prom["jax"][section]), \
            section
    hist = prom["torch"]["histograms"]
    assert hist["sharetrade_train_chunk_seconds"]["count"] == \
        prom["jax"]["histograms"]["sharetrade_train_chunk_seconds"]["count"]
    assert "sharetrade_train_dispatch_gap_ms" in hist


def test_summaries_have_the_same_sections(runs, capsys):
    (_, jdir), (_, tdir) = runs["jax"], runs["torch"]
    sections = {(reader.__module__, d): set(reader(d))
                for reader in (summarize_run_dir, jsummarize)
                for d in (jdir, tdir)}
    assert len(set(map(frozenset, sections.values()))) == 1
    assert {"manifest", "trace", "metrics", "histograms",
            "flight_recorder"} <= next(iter(sections.values()))
    assert cli.main(["obs", "--dir", jdir]) == 0
    printed = json.loads(capsys.readouterr().out)
    assert printed["flight_recorder"]["reason"] == "supervision"
    assert printed["trace"]["dispatch"]["count"] >= CHUNKS


def test_obs_off_creates_no_directory(tmp_path, monkeypatch):
    sets = [s for s in SETS if not s.startswith("obs.enabled")]
    cfg, run = _train("torch", tmp_path, monkeypatch, sets)
    assert not cfg.obs.enabled
    assert not (run / "obs").exists()
    assert sorted(os.listdir(run)) == ["ckpt", "journal"] or \
        sorted(os.listdir(run)) == ["ckpt"]
