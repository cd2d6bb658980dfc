"""The port's serving-plan autotuner (``query/autotune.py``) against the JAX
package on the CPU, with an injected deterministic timer: recall gating,
the nprobe walk, ranking and the rejection bookkeeping give the same plans
(mode, nprobe, recall) and the same rejected modes in both packages.

Twins of the tests of ``tests/test_autotune.py`` that do not probe the TPU
weather (``probe_weather``, ``scan_route`` and the int8 gate are not
ported). Its ``xbin8`` test stands as ``binscan8``: the port serves no
``xbin8``. Tolerance: none; recalls are ratios of equal id sets.
"""

import numpy as np
import pytest

from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu.query.autotune import autotune as j_autotune
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch import DeviceIvfSearcher, ValidationError
from pqvector_tpu_torch.convert import index_from_reference
from pqvector_tpu_torch.query import AutotuneReport, ServingPlan, autotune
from pqvector_tpu_torch.query.autotune import PROBED_MODES, SCAN_MODES, _default_candidates


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
    nprobe walk."""
    got, _ = _both(setup, k=5, recall_target=0.5, modes=("binscan8",))
    assert got.best is not None and got.best.mode == "binscan8"
    assert got.best.nprobe == 0 and "full scan" in got.best.notes
    assert set(SCAN_MODES) == {"scan", "binscan", "binscan8"}


def test_autotune_gather_rejected_not_mistimed(setup):
    """gather has no loop; the tuner must reject it (the loop would
    otherwise time another path)."""
    assert "gather" not in PROBED_MODES
    assert "gather" not in _default_candidates()
    got, want = _both(setup, k=5, recall_target=0.5, modes=("gather",))
    assert got.best is None and "gather" in got.rejected
    assert got.rejected == want.rejected


def test_autotune_default_candidates(setup):
    """Every probed and every scan mode the port serves, the int8 modes
    included; each plan meets the target."""
    assert _default_candidates() == PROBED_MODES + SCAN_MODES
    got, _ = _both(setup, k=5, recall_target=0.9)
    modes = {p.mode for p in got.plans}
    assert modes | set(got.rejected) == set(_default_candidates())
    assert all(p.recall >= 0.9 for p in got.plans)
    assert {"pallas", "stream"} <= modes
