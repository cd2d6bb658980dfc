"""The port's serving-plan autotuner (``query/autotune.py``) against the JAX
package on the CPU, with an injected deterministic timer: recall gating,
the nprobe walk, ranking and the rejection bookkeeping give the same plans
(mode, nprobe, recall) and the same rejected modes in both packages.

Twins of the tests of ``tests/test_autotune.py``, the weather probe
(``probe_weather``, ``WeatherReport``) and the weather-routed ``autoscan``
(``scan_route``) included, with an injected timer and prober; not the
int8 validation gate, which guards Mosaic kernels on a TPU and is not
ported. Tolerance: none; recalls are ratios of equal id sets, and with the
same injected timer both packages' weather reports are equal. Searches
through ``autoscan`` give the JAX package's ids, except rows whose f32
distances tie within 1e-5 relative.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu.errors import ValidationError as JValidationError
from pqvector_tpu.query.autotune import autotune as j_autotune
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch import DeviceIvfSearcher, ValidationError
from pqvector_tpu_torch.convert import index_from_reference
from pqvector_tpu_torch.query import (AutotuneReport, ServingPlan, WeatherReport, autotune,
                                      probe_weather)
from pqvector_tpu_torch.query.autotune import (DEPRIORITIZED, PROBED_MODES, SCAN_MODES,
                                               _default_candidates)

# the module, not the ``autotune`` function the package exports in its place
jat = importlib.import_module("pqvector_tpu.query.autotune")


def _data():
    rng = np.random.default_rng(11)
    centers = 6.0 * rng.standard_normal((12, 16)).astype(np.float32)
    x = (centers[rng.integers(0, 12, 1500)]
         + rng.standard_normal((1500, 16))).astype(np.float32)
    jindex = j_build_ivf_index(JEmbeddings(x, 16), JIvfBuildConfig(n_clusters=12, seed=0))
    index = index_from_reference(np.asarray(jindex.centroids), jindex.list_offsets,
                                 jindex.row_ids)
    q = (x[rng.integers(0, 1500, 24)] + 0.3 * rng.standard_normal((24, 16))).astype(np.float32)
    return x, jindex, index, q


@pytest.fixture(scope="module")
def setup():
    x, jindex, index, q = _data()
    return (JSearcher(jindex, x, cluster_sorted=True),
            DeviceIvfSearcher(index, x, cluster_sorted=True, device="cpu"), q)


class FakeTimer:
    """Deterministic clock: each call advances a fixed step."""

    def __init__(self, step=1.0):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _both(setup, **kw):
    js, ts, q = setup
    kw = dict(dict(reps=2, budget_s=0.5), **kw)
    return (autotune(ts, q, timer=FakeTimer(), **kw),
            j_autotune(js, q, timer=FakeTimer(), **kw))


def _same_plans(got, want):
    assert [(p.mode, p.nprobe, p.recall, p.batch, p.k, p.notes) for p in got.plans] == [
        (p.mode, p.nprobe, p.recall, p.batch, p.k, p.notes) for p in want.plans]
    assert sorted(got.rejected) == sorted(want.rejected)


def test_autotune_finds_plans(setup):
    got, want = _both(setup, k=5, recall_target=0.9, modes=("masked", "gather"))
    assert isinstance(got, AutotuneReport) and isinstance(got.best, ServingPlan)
    assert {p.mode for p in got.plans} <= {"masked", "gather"}
    for p in got.plans:
        assert p.recall >= 0.9 and p.nprobe >= 1 and p.qps > 0
    qps = [p.qps for p in got.plans]
    assert qps == sorted(qps, reverse=True)
    _same_plans(got, want)


def test_autotune_nprobe_walk_is_minimal(setup):
    loose, jloose = _both(setup, k=5, recall_target=0.5, modes=("masked",))
    tight, jtight = _both(setup, k=5, recall_target=0.98, modes=("masked",))
    assert loose.best is not None and tight.best is not None
    assert loose.best.nprobe <= tight.best.nprobe
    assert tight.best.recall >= 0.98
    _same_plans(loose, jloose)
    _same_plans(tight, jtight)


def test_autotune_scan_modes_are_nprobe_free(setup):
    got, want = _both(setup, k=5, recall_target=0.5, modes=("scan",))
    assert got.best is not None and got.best.nprobe == 0
    assert "full scan" in got.best.notes
    _same_plans(got, want)


def test_autotune_rejects_unreachable_target(setup):
    got, want = _both(setup, k=5, recall_target=1.01, modes=("masked",))
    assert got.best is None and "masked" in got.rejected
    assert got.rejected == want.rejected


def test_autotune_rejects_ineligible_mode(setup):
    """stream takes k <= 128: k = 200 lands in ``rejected`` with the
    ValidationError's text, and does not stop the tuner."""
    got, want = _both(setup, k=200, recall_target=0.5, modes=("stream", "masked"))
    assert "stream" in got.rejected
    assert any(p.mode == "masked" for p in got.plans)
    _same_plans(got, want)


def test_autotune_validates_queries(setup):
    _, ts, _ = setup
    with pytest.raises(ValidationError, match="query sample"):
        autotune(ts, np.zeros((0, 16), np.float32))


def test_autotune_spilled_searcher():
    """The tuner runs unchanged on a spilled layout (its exact truth stays
    the true top-k through the dedup)."""
    x, jindex, index, q = _data()
    sp = DeviceIvfSearcher.with_spill(index, x, spill=0.3, device="cpu")
    jsp = JSearcher.with_spill(jindex, x, spill=0.3)
    kw = dict(k=5, recall_target=0.9, modes=("masked",), reps=2, budget_s=0.5)
    got = autotune(sp, q, timer=FakeTimer(), **kw)
    assert got.best is not None and got.best.recall >= 0.9
    _same_plans(got, j_autotune(jsp, q, timer=FakeTimer(), **kw))


def test_autotune_binscan8_is_scan_mode(setup):
    """The int8 full scan classifies as a scan mode: an nprobe-free plan, no
    nprobe walk; the scan modes are the JAX package's."""
    got, _ = _both(setup, k=5, recall_target=0.5, modes=("binscan8",))
    assert got.best is not None and got.best.mode == "binscan8"
    assert got.best.nprobe == 0 and "full scan" in got.best.notes
    assert SCAN_MODES == jat.SCAN_MODES and DEPRIORITIZED == jat.DEPRIORITIZED


@pytest.mark.parametrize("mode", ["xbin8", "xbin"])
def test_autotune_xbin8_is_scan_mode(setup, mode):
    """``xbin8`` (and ``xbin``) classify as full-scan modes: an nprobe-free
    plan and no nprobe walk; the plan is the JAX package's."""
    got, want = _both(setup, k=5, recall_target=0.5, modes=(mode,))
    assert got.best is not None and got.best.mode == mode
    assert got.best.nprobe == 0 and "full scan" in got.best.notes
    _same_plans(got, want)


def test_autotune_gather_rejected_not_mistimed(setup):
    """gather has no loop; the tuner must reject it (the loop would
    otherwise time another path)."""
    assert "gather" not in PROBED_MODES
    assert "gather" not in _default_candidates()
    got, want = _both(setup, k=5, recall_target=0.5, modes=("gather",))
    assert got.best is None and "gather" in got.rejected
    assert got.rejected == want.rejected


def test_autotune_default_candidates(setup):
    """Every probed and every scan mode but the deprioritized packed-key
    scans, the int8 modes included (the JAX package's list off the TPU);
    each plan meets the target."""
    assert _default_candidates() == tuple(
        m for m in PROBED_MODES + SCAN_MODES if m not in DEPRIORITIZED)
    assert _default_candidates() == jat._default_candidates()
    got, _ = _both(setup, k=5, recall_target=0.9)
    modes = {p.mode for p in got.plans}
    assert modes | set(got.rejected) == set(_default_candidates())
    assert all(p.recall >= 0.9 for p in got.plans)
    assert {"pallas", "stream"} <= modes


def test_autotune_serves_the_deprioritized_modes_on_request(setup):
    """``modes=("xbin", "xbin8", "tilescan")`` serves what the default
    leaves out: tilescan is refused on this cluster-sorted layout, in both
    packages."""
    got, want = _both(setup, k=5, recall_target=0.5, modes=("xbin", "xbin8", "tilescan"))
    assert {p.mode for p in got.plans} == {"xbin", "xbin8"}
    assert "cluster-sorted" in got.rejected["tilescan"]
    _same_plans(got, want)


def test_probe_weather_reports(setup):
    js, ts, q = setup
    rep = probe_weather(ts, q, k=5, reps=2, budget_s=0.5, timer=FakeTimer())
    assert isinstance(rep, WeatherReport)
    assert rep.floor_qps > 0 and rep.extract_qps > 0
    assert rep.extract_frac == pytest.approx(rep.extract_qps / rep.floor_qps)
    assert rep.batch == len(q) and rep.k == 5
    assert not rep.degraded  # one clock for both loops: frac 1.0
    want = jat.probe_weather(js, q, k=5, reps=2, budget_s=0.5, timer=FakeTimer())
    assert dataclasses.astuple(rep) == dataclasses.astuple(want)


def test_probe_weather_degraded_threshold(setup):
    js, ts, q = setup
    rep = probe_weather(ts, q, k=5, reps=2, budget_s=0.5, degraded_below=2.0,
                        timer=FakeTimer())
    assert rep.degraded
    want = jat.probe_weather(js, q, k=5, reps=2, budget_s=0.5, degraded_below=2.0,
                             timer=FakeTimer())
    assert dataclasses.astuple(rep) == dataclasses.astuple(want)


def test_probe_weather_validates_input(setup):
    js, ts, _ = setup
    for bad, kw in ((np.zeros((0, 16), np.float32), {}),
                    (np.zeros((4, 16), np.float32), {"k": 0}),
                    (np.zeros((4, 17), np.float32), {})):
        with pytest.raises(ValidationError):
            probe_weather(ts, bad, **kw)
        with pytest.raises(JValidationError):
            jat.probe_weather(js, bad, **kw)


class FakeProber:
    """Injected prober: a report with a chosen degraded flag, in the report
    type of the package it serves."""

    def __init__(self, degraded, report=WeatherReport):
        self.degraded = degraded
        self.report = report
        self.calls = 0

    def __call__(self, searcher, q, k, budget_s=1.0):
        self.calls += 1
        frac = 0.1 if self.degraded else 0.6
        return self.report(floor_qps=100.0, extract_qps=100.0 * frac, extract_frac=frac,
                           degraded=self.degraded, batch=len(q), k=k)


def _weather(searchers, degraded):
    js, ts = searchers
    js._weather = ts._weather = None
    js.weather_prober = FakeProber(degraded, jat.WeatherReport)
    ts.weather_prober = FakeProber(degraded)


def _clear(*searchers):
    for s in searchers:
        s.weather_prober = None
        s._weather = None


def _same_or_tied(got, want, x, q):
    gi, wi = got[1].numpy(), np.asarray(want[1])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-6)
    for b, c in zip(*np.nonzero(gi != wi)):
        d_g = ((x[gi[b, c]] - q[b]) ** 2).sum()
        d_w = ((x[wi[b, c]] - q[b]) ** 2).sum()
        assert abs(d_g - d_w) <= 1e-5 * max(d_w, 1e-12)


def test_autoscan_routes_by_weather(setup):
    js, ts, q = setup
    x = _data()[0]
    try:
        _weather((js, ts), degraded=False)
        assert ts.scan_route(q, k=5) == js.scan_route(q, k=5) == "scan"
        _weather((js, ts), degraded=True)
        route = ts.scan_route(q, k=5)
        assert route == js.scan_route(q, k=5)
        assert route == ("binscan" if ts.can_binscan(5) else "scan")
        for degraded in (False, True):
            _weather((js, ts), degraded)
            got = ts.search(q, k=5, nprobe=1, mode="autoscan")
            assert got[1].shape == (len(q), 5)
            _same_or_tied(got, js.search(q, k=5, nprobe=1, mode="autoscan"), x, q)
            mode = ts.scan_route(q, k=5)
            assert torch.equal(got[1], ts.search(q, k=5, nprobe=1, mode=mode)[1])
    finally:
        _clear(js, ts)


def test_autoscan_probe_cached_by_ttl(setup):
    _, ts, q = setup
    prober = FakeProber(degraded=False)
    ts.weather_prober = prober
    ts._weather = None
    old_ttl = ts.weather_ttl_s
    try:
        ts.weather_ttl_s = 1e9
        ts.scan_route(q, k=5)
        ts.scan_route(q, k=5)
        assert prober.calls == 1
        ts.scan_route(q, k=5, force=True)
        assert prober.calls == 2
        ts.weather_ttl_s = 0.0
        ts.scan_route(q, k=5)
        assert prober.calls == 3
    finally:
        ts.weather_ttl_s = old_ttl
        _clear(ts)


def test_autoscan_ineligible_shapes_stay_scan(setup):
    """Shapes binscan cannot serve route to scan without probing, in both
    packages."""
    js, ts, q = setup
    try:
        _weather((js, ts), degraded=True)
        k = 4096  # beyond the bins of binscan's largest tile
        assert not ts.can_binscan(k) and not js.can_binscan(k)
        assert ts.scan_route(q, k=k) == js.scan_route(q, k=k) == "scan"
        assert ts.weather_prober.calls == js.weather_prober.calls == 0
    finally:
        _clear(js, ts)


def test_autoscan_exact_paths_resolve(setup):
    """``exact``/``exact_loop`` speak ``approx``, not ``scan``: autoscan
    translates the route for them, as in the JAX package."""
    js, ts, q = setup
    x = _data()[0]
    try:
        for degraded in (False, True):
            _weather((js, ts), degraded)
            got = ts.exact(q, k=5, mode="autoscan")
            assert got[1].shape == (len(q), 5)
            _same_or_tied(got, js.exact(q, k=5, mode="autoscan"), x, q)
            got = ts.exact_loop(q, k=5, reps=2, mode="autoscan")
            _same_or_tied(got, js.exact_loop(q, k=5, reps=2, mode="autoscan"), x, q)
    finally:
        _clear(js, ts)
