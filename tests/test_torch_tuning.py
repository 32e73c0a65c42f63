"""The port's ``tuning.py`` against the JAX package's, on the CPU.

- Precedence parity: the same configs (explicit, profile, default, and a
  ``--set`` pin at the default value) through both packages'
  ``apply_profile`` give the same registered knobs, and ``describe`` the
  same sources; applying twice changes nothing.
- The profile file: written atomically, a torn file, a bad schema, an
  unregistered knob and a missing file refused; a foreign fingerprint
  refused unless ``tuning.allow_fingerprint_mismatch``, a CPU sweep on a
  GPU host among them; the registry is the JAX one path for path; a
  profile written by either package is read by the other's
  ``load_profile``.
- The port's orchestrator applies the profile (idempotent with the CLI's
  resolution).
"""

import json

import pytest

from sharetrade_tpu import tuning as jt
from sharetrade_tpu.config import FrameworkConfig as JConfig
from sharetrade_tpu_torch import tuning as tt
from sharetrade_tpu_torch.config import ConfigError, FrameworkConfig

PROFILE_KNOBS = {"serve.batch_timeout_ms": 0.5, "serve.max_queue": 128,
                 "runtime.megachunk_factor": 8, "serve.max_batch": 32}


def _write(mod, tmp_path, knobs, name):
    path = str(tmp_path / name)
    mod.write_profile(path, mod.build_profile(knobs, seed=3,
                                              objectives={"x": {"q": 1.0}}))
    return path


def test_registry_and_schema_are_the_jax_ones():
    assert [(k.path, k.tier, k.kind) for k in tt.KNOBS] == \
        [(k.path, k.tier, k.kind) for k in jt.KNOBS]
    assert tt.PROFILE_SCHEMA_VERSION == jt.PROFILE_SCHEMA_VERSION == 1
    assert tt.default_knob_values() == jt.default_knob_values()
    assert issubclass(tt.ProfileError, ConfigError)
    fp = tt.host_fingerprint()
    assert set(jt.host_fingerprint()) - {"device_name"} <= set(fp)
    assert fp["backend"] == "cpu" and fp["device_count"] == 1
    assert fp["device_name"] is None


CASES = {
    "profile_over_default": [],
    "explicit_value_wins": ["serve.batch_timeout_ms=7.0",
                            "runtime.megachunk_factor=2"],
    "set_pin_at_default_wins": ["serve.max_queue=1024"],
    "mixed": ["serve.max_batch=64", "runtime.pipeline_depth=4"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_precedence_parity(case, tmp_path):
    jpath = _write(jt, tmp_path, PROFILE_KNOBS, "jax.json")
    tpath = _write(tt, tmp_path, PROFILE_KNOBS, "torch.json")
    jcfg = JConfig().apply_overrides([f"tuning.profile={jpath}",
                                      *CASES[case]])
    tcfg = FrameworkConfig().apply_overrides([f"tuning.profile={tpath}",
                                              *CASES[case]])
    jout, tout = jt.apply_profile(jcfg), tt.apply_profile(tcfg)
    assert tt.knob_vector(tout) == jt.knob_vector(jout)
    jdesc, tdesc = jt.describe(jout), tt.describe(tout)
    assert {k: (v["value"], v["source"]) for k, v in tdesc["knobs"].items()} \
        == {k: (v["value"], v["source"]) for k, v in jdesc["knobs"].items()}
    # Idempotent: the orchestrator's second application changes nothing.
    assert tt.apply_profile(tout).to_dict() == tout.to_dict()
    assert tt.describe(tt.apply_profile(tout))["knobs"] == tdesc["knobs"]
    # Untouched config outside the registry.
    assert tout.serve.slots == FrameworkConfig().serve.slots


def test_sources_and_no_profile(tmp_path):
    path = _write(tt, tmp_path, PROFILE_KNOBS, "p.json")
    cfg = FrameworkConfig().apply_overrides(
        [f"tuning.profile={path}", "serve.batch_timeout_ms=7.0"])
    out = tt.apply_profile(cfg)
    knobs = tt.describe(out)["knobs"]
    assert knobs["serve.batch_timeout_ms"]["source"] == "explicit"
    assert knobs["runtime.megachunk_factor"]["source"] == "profile"
    assert knobs["runtime.megachunk_factor"]["value"] == 8
    assert knobs["distrib.ingest_every_updates"]["source"] == "default"
    plain = FrameworkConfig()
    assert tt.apply_profile(plain) is plain
    assert tt.describe(plain)["profile"] is None


def test_atomic_write_and_refusals(tmp_path):
    path = _write(tt, tmp_path, {"serve.batch_timeout_ms": 0.5}, "p.json")
    doc = tt.load_profile(path)
    assert doc["knobs"] == {"serve.batch_timeout_ms": 0.5}
    assert doc["seed"] == 3 and doc["schema_version"] == 1
    assert [p.name for p in tmp_path.iterdir()] == ["p.json"]
    with pytest.raises(tt.ProfileError, match="unregistered"):
        tt.build_profile({"serve.nonsense_knob": 1})
    bad = dict(doc, schema_version=999)
    with pytest.raises(tt.ProfileError, match="schema_version"):
        tt.write_profile(str(tmp_path / "w.json"), bad)
    (tmp_path / "v.json").write_text(json.dumps(bad))
    with pytest.raises(tt.ProfileError, match="schema_version"):
        tt.load_profile(str(tmp_path / "v.json"))
    (tmp_path / "torn.json").write_text('{"knobs": {')
    with pytest.raises(tt.ProfileError, match="unreadable"):
        tt.load_profile(str(tmp_path / "torn.json"))
    (tmp_path / "u.json").write_text(json.dumps(
        dict(doc, knobs={"serve.bogus": 1})))
    with pytest.raises(tt.ProfileError, match="unregistered"):
        tt.load_profile(str(tmp_path / "u.json"))
    cfg = FrameworkConfig()
    cfg.tuning.profile = str(tmp_path / "absent.json")
    with pytest.raises(tt.ProfileError, match="not found"):
        tt.apply_profile(cfg)


@pytest.mark.parametrize("field,value", [("cpu_count", 99999),
                                         ("backend", "tpu"),
                                         ("device_count", 8)])
def test_foreign_fingerprint_refused_unless_allowed(field, value, tmp_path):
    doc = tt.build_profile({"runtime.megachunk_factor": 4})
    doc["fingerprint"] = dict(doc["fingerprint"], **{field: value})
    path = str(tmp_path / "p.json")
    tt.write_profile(path, doc)
    cfg = FrameworkConfig()
    cfg.tuning.profile = path
    with pytest.raises(tt.ProfileError, match="different host"):
        tt.apply_profile(cfg)
    assert tt.fingerprint_mismatches(doc["fingerprint"]) == [field]
    cfg.tuning.allow_fingerprint_mismatch = True
    assert tt.apply_profile(cfg).runtime.megachunk_factor == 4
    # The card's name never gates.
    doc["fingerprint"] = dict(tt.host_fingerprint(), device_name="other")
    assert tt.fingerprint_mismatches(doc["fingerprint"]) == []


def test_a_cpu_sweep_on_a_gpu_host_is_fingerprinted_cpu(tmp_path,
                                                        monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    assert tt.host_fingerprint()["backend"] == "gpu"
    doc = tt.build_profile({"serve.max_batch": 32}, device="cpu")
    assert doc["fingerprint"]["backend"] == "cpu"
    assert doc["fingerprint"]["device_name"] is None
    assert tt.build_profile({}, device="cuda:0")["fingerprint"][
        "backend"] == "gpu"
    path = str(tmp_path / "p.json")
    tt.write_profile(path, doc)
    cfg = FrameworkConfig()
    cfg.tuning.profile = path
    with pytest.raises(tt.ProfileError, match="different host"):
        tt.apply_profile(cfg)


def test_each_package_reads_the_others_profile(tmp_path):
    jpath = _write(jt, tmp_path, PROFILE_KNOBS, "jax.json")
    tpath = _write(tt, tmp_path, PROFILE_KNOBS, "torch.json")
    from_jax, from_torch = tt.load_profile(jpath), jt.load_profile(tpath)
    assert from_jax["knobs"] == from_torch["knobs"] == PROFILE_KNOBS
    assert set(from_jax) == set(from_torch)
    # The CPU fingerprints of the two packages agree on the gating keys
    # only where both probe the same backend; with the mismatch allowed
    # each package applies the other's profile to the same knobs.
    for mod, cfg_cls, path in ((tt, FrameworkConfig, jpath),
                               (jt, JConfig, tpath)):
        cfg = cfg_cls().apply_overrides([f"tuning.profile={path}",
                                         "tuning.allow_fingerprint_"
                                         "mismatch=true"])
        assert {k: mod.get_knob(mod.apply_profile(cfg), k)
                for k in PROFILE_KNOBS} == PROFILE_KNOBS


def test_orchestrator_applies_the_profile(tmp_path):
    from sharetrade_tpu_torch.runtime.orchestrator import Orchestrator
    path = _write(tt, tmp_path, {"runtime.megachunk_factor": 4,
                                 "runtime.pipeline_depth": 3}, "p.json")
    cfg = FrameworkConfig().apply_overrides(
        [f"tuning.profile={path}", "runtime.pipeline_depth=2",
         f"runtime.checkpoint_dir={tmp_path / 'ck'}", "env.window=8",
         "model.hidden_dim=8"])
    orch = Orchestrator(cfg, device="cpu")
    try:
        assert orch.cfg.runtime.megachunk_factor == 4
        assert orch.cfg.runtime.pipeline_depth == 2     # explicit wins
    finally:
        orch.stop()
    cfg.tuning.profile = str(tmp_path / "gone.json")
    with pytest.raises(tt.ProfileError):
        Orchestrator(cfg, device="cpu")
