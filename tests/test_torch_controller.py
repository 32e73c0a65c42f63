"""The port's online serve controller against the JAX package's, on the CPU.

Both controllers are stepped in lockstep on a fake clock through stub
engines (each package's live-knob tuple, histogram and registry, with the
real engines' clamp semantics), over the synthetic p99 series of
``tests/test_autotune.py``'s state-machine tests: tighten, floors and
ceilings, dead band, a noisy p99 (no oscillation), the overload veto, the
rate limit and no signal. Every step's ``Adjustment`` and the knob
trajectories must be identical, and the visible gauges and counters agree.
No engine, no thread, no sleep.
"""

import pytest

from sharetrade_tpu.config import ServeConfig as JServeConfig
from sharetrade_tpu.obs.hist import Histogram as JHistogram
from sharetrade_tpu.serve.controller import ServeController as JController
from sharetrade_tpu.serve.engine import _LiveKnobs as JKnobs
from sharetrade_tpu.utils.metrics import MetricsRegistry as JRegistry
from sharetrade_tpu_torch.config import ConfigError, ServeConfig
from sharetrade_tpu_torch.obs.hist import Histogram
from sharetrade_tpu_torch.serve import Adjustment, ServeController
from sharetrade_tpu_torch.serve.engine import _LiveKnobs
from sharetrade_tpu_torch.utils.metrics import MetricsRegistry

SERVE = dict(max_batch=16, slots=64, batch_timeout_ms=8.0, max_queue=512)


class FakeEngine:
    """The surface a controller reads and moves, with the engines' clamp
    to the configured ceilings; one per package."""

    def __init__(self, cfg, knobs_cls, hist_cls, registry_cls):
        self.cfg = cfg
        self._knobs_cls = knobs_cls
        self.knobs = knobs_cls(float(cfg.batch_timeout_ms),
                               int(cfg.max_queue))
        self.registry = registry_cls()
        self.latency_histogram = hist_cls()
        self.depth = 0
        self.history = []

    def queue_depth(self):
        return self.depth

    def set_knobs(self, *, batch_timeout_ms=None, max_queue=None):
        self.knobs = self._knobs_cls(
            min(float(batch_timeout_ms), self.cfg.batch_timeout_ms),
            min(int(max_queue), self.cfg.max_queue))
        self.history.append(tuple(self.knobs))
        return self.knobs


class Lockstep:
    """The two controllers on one fake clock; every window is fed to both
    histograms and every step's result compared."""

    def __init__(self, **kw):
        kw.setdefault("target_p99_ms", 50.0)
        kw.setdefault("interval_s", 1.0)
        self.now = [0.0]
        clock = lambda: self.now[0]  # noqa: E731
        self.j = FakeEngine(JServeConfig(**SERVE), JKnobs, JHistogram,
                            JRegistry)
        self.t = FakeEngine(ServeConfig(**SERVE), _LiveKnobs, Histogram,
                            MetricsRegistry)
        self.jc = JController(self.j, clock=clock, **kw)
        self.tc = ServeController(self.t, clock=clock, **kw)
        self.adjustments = []

    def feed(self, p99_ms, n=200):
        """A window whose p99 is ~``p99_ms``: the bulk at half of it, the
        tail (1%) at it."""
        tail = max(2, n // 100)
        for engine in (self.j, self.t):
            for _ in range(n - tail):
                engine.latency_histogram.observe(p99_ms * 0.5)
            for _ in range(tail):
                engine.latency_histogram.observe(p99_ms)

    def tick(self, p99, dt=1.0, shed=0, depth=0):
        self.now[0] += dt
        if p99 is not None:
            self.feed(p99)
        for engine in (self.j, self.t):
            if shed:
                engine.registry.inc("serve_shed_total", shed)
            engine.depth = depth
        ja = self.jc.step(now=self.now[0])
        ta = self.tc.step(now=self.now[0])
        assert (None if ta is None else tuple(ta)) == \
            (None if ja is None else tuple(ja))
        assert tuple(self.t.knobs) == tuple(self.j.knobs)
        assert self.tc.adjustments == self.jc.adjustments
        self.adjustments.append(ta)
        return ta

    def check_visible(self):
        assert self.t.history == self.j.history
        jc, tc = self.j.registry.counters(), self.t.registry.counters()
        assert tc == jc
        js, ts = self.j.registry.snapshot(), self.t.registry.snapshot()
        assert ts == js


def test_tighten_is_bounded_per_tick():
    ls = Lockstep()
    adj = ls.tick(200.0)
    assert isinstance(adj, Adjustment) and adj.action == "tighten"
    assert adj.batch_timeout_ms == pytest.approx(4.0) and adj.max_queue == 256
    adj = ls.tick(200.0)
    assert adj.batch_timeout_ms == pytest.approx(2.0) and adj.max_queue == 128
    ls.check_visible()
    assert ls.t.registry.counters()["serve_controller_adjustments_total"] == 2
    assert ls.t.registry.snapshot()["serve_controller_target_p99_ms"] == 50.0


def test_floors_and_ceilings():
    ls = Lockstep()
    for _ in range(20):
        ls.tick(500.0)
    assert tuple(ls.t.knobs) == (0.0, 16)           # floor = max_batch
    for _ in range(40):
        ls.tick(1.0)
    assert tuple(ls.t.knobs) == (pytest.approx(8.0), 512)
    ls.check_visible()
    actions = [a.action for a in ls.adjustments if a is not None]
    assert "tighten" in actions and "relax" in actions


@pytest.mark.parametrize("series", [
    [30.0, 45.0, 27.0, 40.0, 35.0],                     # dead band
    [48, 53, 47, 52, 49, 55, 46, 51, 44, 56, 48, 53],   # noisy around 50
], ids=["dead_band", "noisy_no_oscillation"])
def test_noise_never_flaps(series):
    ls = Lockstep()
    for p in series:
        ls.tick(float(p))
    assert all(a is None or a.action == "tighten" for a in ls.adjustments)
    timeouts = [k[0] for k in ls.t.history]
    queues = [k[1] for k in ls.t.history]
    assert timeouts == sorted(timeouts, reverse=True)
    assert queues == sorted(queues, reverse=True)
    ls.check_visible()


def test_overload_vetoes_relax():
    ls = Lockstep()
    ls.tick(200.0)
    tightened = tuple(ls.t.knobs)
    assert ls.tick(5.0, shed=50) is None            # sheds: hold
    assert ls.tick(5.0, depth=256) is None          # pinned queue: hold
    assert tuple(ls.t.knobs) == tightened
    adj = ls.tick(5.0)
    assert adj is not None and adj.action == "relax"
    ls.check_visible()
    assert ls.t.registry.snapshot()["serve_controller_window_bad"] == 0.0


def test_rate_limit_one_adjustment_per_interval():
    ls = Lockstep()
    ls.tick(200.0, dt=1.0)
    assert ls.tick(200.0, dt=0.1) is None
    assert ls.tc.adjustments == 1
    # The early call left the window intact: the next on-time tick sees
    # both feeds.
    ls.tick(200.0, dt=1.0)
    assert ls.t.registry.snapshot()[
        "serve_controller_window_completed"] == 400.0
    ls.check_visible()


def test_no_signal_holds():
    ls = Lockstep()
    assert ls.tick(None) is None
    assert ls.tc.adjustments == 0
    ls.check_visible()


@pytest.mark.parametrize("kw", [{"target_p99_ms": 0.0},
                                {"interval_s": 0.0},
                                {"shrink": 1.5},
                                {"rearm_frac": 1.0}])
def test_bad_params_refused_as_in_jax(kw):
    args = {"target_p99_ms": 50.0, **kw}
    with pytest.raises(ConfigError):
        ServeController(FakeEngine(ServeConfig(), _LiveKnobs, Histogram,
                                   MetricsRegistry), **args)
    with pytest.raises(Exception) as jexc:
        JController(FakeEngine(JServeConfig(), JKnobs, JHistogram,
                               JRegistry), **args)
    assert "ConfigError" in type(jexc.value).__name__


def test_start_stop_runs_on_its_stop_event():
    """The daemon thread waits on its stop event (no sleep): ``stop``
    returns at once, long before a tick would have come."""
    import time
    engine = FakeEngine(ServeConfig(**SERVE), _LiveKnobs, Histogram,
                        MetricsRegistry)
    ctl = ServeController(engine, target_p99_ms=50.0,
                          interval_s=3600.0).start()
    assert ctl._thread.daemon and ctl._thread.is_alive()
    t0 = time.perf_counter()
    ctl.stop()
    assert not ctl._thread.is_alive() and time.perf_counter() - t0 < 5.0
