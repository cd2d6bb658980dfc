"""The loops' deferred re-score (``loop_rescore``, ``_loop_defer_rescore``,
``_hbm_bytes``) of the port against the JAX package on the CPU.

Twins of ``tests/test_loop_defer.py``, one for each of its tests, on its
near-tie fixture (groups of 4 rows 1e-4 apart, below bf16's resolution, so
only the f32 copy ranks a group): the same inputs go through both packages'
``search_loop``/``exact_loop`` under ``loop_rescore="body"`` and ``"defer"``,
and the port is held to the JAX result and to the JAX test's assertions.
Then the deferred loop against its definition: every repetition selects
``min(2k, n_pad)`` at storage precision with the f32 copy held back, and the
last one's winners are re-scored once against the copy.

Tolerance: ids equal, except that rows whose f32 distances tie within 1e-5
relative may swap; distances within rtol 1e-4 / atol 1e-5 of the f32 ones.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch import DeviceIvfSearcher, ValidationError
from pqvector_tpu_torch.convert import index_from_reference
from pqvector_tpu_torch.kernels.scan_topk import _refine


@pytest.fixture(scope="module")
def near_tie():
    rng = np.random.default_rng(7)
    n_groups, per, d = 128, 4, 32
    centers = rng.uniform(-4, 4, (n_groups, d)).astype(np.float32)
    rows = []
    for g in range(n_groups):
        for j in range(per):
            rows.append(centers[g] + (1e-4 * j) * np.eye(d, dtype=np.float32)[0])
    x = np.stack(rows).astype(np.float32)
    jindex = j_build_ivf_index(JEmbeddings(x, d), JIvfBuildConfig(n_clusters=8, seed=0))
    index = index_from_reference(np.asarray(jindex.centroids), jindex.list_offsets,
                                 jindex.row_ids)
    gq = rng.integers(0, n_groups, 32)
    q = centers[gq].copy()
    q[:, 0] += 2.1e-4
    return x, jindex, index, q


def _pair(near_tie, spill=0.0):
    x, jindex, index, _ = near_tie
    if spill:
        return (JSearcher.with_spill(jindex, x, spill=spill, dtype=jnp.bfloat16, row_tile=128),
                DeviceIvfSearcher.with_spill(index, x, spill=spill, dtype=torch.bfloat16,
                                             row_tile=128, device="cpu"))
    return (JSearcher(jindex, x, dtype=jnp.bfloat16, row_tile=128),
            DeviceIvfSearcher(index, x, dtype=torch.bfloat16, row_tile=128, device="cpu"))


def _f32_truth(x, q, k):
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return np.argsort(d2, axis=1, kind="stable")[:, :k]


def _assert_same(got, want, x, q):
    gd, gi = got[0].numpy(), got[1].numpy()
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_allclose(gd, wd, rtol=1e-4, atol=1e-5)
    for b, c in zip(*np.nonzero(gi != wi)):
        assert gi[b, c] >= 0 and wi[b, c] >= 0
        d_g = ((x[gi[b, c]] - q[b]) ** 2).sum()
        d_w = ((x[wi[b, c]] - q[b]) ** 2).sum()
        assert abs(d_g - d_w) <= 1e-5 * max(d_w, 1e-12), (b, c)


class FakeEmb:
    """The two fields the sizing policy reads, without the memory."""

    def __init__(self, n, d, dtype):
        self.shape = (n, d)
        self.dtype = dtype


def test_auto_policy_sizes_against_hbm(near_tie, monkeypatch):
    """The auto decision defers exactly where the JAX package's does: 10M x
    96 bf16 with its f32 copy stays in the body, 12M defers, on the CPU's
    16 GiB default, ``PQVECTOR_TPU_HBM_GB`` scaling it; f32 storage never
    defers; "body" and "defer" force it; anything else raises."""
    x, jindex, index, _ = near_tie
    js, ts = _pair(near_tie)
    assert ts._emb_ref is not None
    assert not ts._loop_defer_rescore() and not js._loop_defer_rescore()
    assert ts._hbm_bytes() == js._hbm_bytes() == 16 * 2**30
    for n, want in ((10_002_432, False), (12_003_328, True)):
        js.emb = FakeEmb(n, 96, jnp.bfloat16)
        ts.emb = FakeEmb(n, 96, torch.bfloat16)
        assert ts._loop_defer_rescore() == js._loop_defer_rescore() == want
    monkeypatch.setenv("PQVECTOR_TPU_HBM_GB", "32")
    assert ts._hbm_bytes() == js._hbm_bytes() == 32 * 2**30
    assert not ts._loop_defer_rescore() and not js._loop_defer_rescore()
    monkeypatch.delenv("PQVECTOR_TPU_HBM_GB")

    s3 = DeviceIvfSearcher(index, x, row_tile=128, device="cpu")
    s3.emb = FakeEmb(12_003_328, 96, torch.float32)
    assert not s3._loop_defer_rescore()

    ts.loop_rescore = js.loop_rescore = "body"
    assert not ts._loop_defer_rescore() and not js._loop_defer_rescore()
    ts.loop_rescore = js.loop_rescore = "defer"
    assert ts._loop_defer_rescore() and js._loop_defer_rescore()
    ts.loop_rescore = "bogus"
    with pytest.raises(ValidationError, match="loop_rescore"):
        ts._loop_defer_rescore()


@pytest.mark.parametrize("mode", ["scan", "binscan", "masked", "pallas"])
def test_search_loop_defer_matches_body(near_tie, mode):
    """Deferred and in-body re-score both rank the sub-bf16 ties through
    the f32 rows: top-1 recovered, distances f32-exact, and the JAX
    package's results in both forms."""
    x, _, _, q = near_tie
    k = 4
    js, ts = _pair(near_tie)
    tids = _f32_truth(x, q, k)
    for form in ("body", "defer"):
        ts.loop_rescore = js.loop_rescore = form
        got = ts.search_loop(q, k, nprobe=8, reps=2, mode=mode)
        _assert_same(got, js.search_loop(q, k, nprobe=8, reps=2, mode=mode), x, q)
        d, ids = got[0].numpy(), got[1].numpy()
        assert (ids[:, 0] == tids[:, 0]).mean() >= 0.95
        want = np.sqrt(((q[:, None, :] - x[ids]) ** 2).sum(-1))
        np.testing.assert_allclose(d, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("mode", ["xla", "approx", "binscan", "stream"])
def test_exact_loop_defer_matches_body(near_tie, mode):
    x, _, _, q = near_tie
    k = 4
    js, ts = _pair(near_tie)
    tids = _f32_truth(x, q, k)
    for form in ("body", "defer"):
        ts.loop_rescore = js.loop_rescore = form
        got = ts.exact_loop(q, k, reps=2, mode=mode)
        _assert_same(got, js.exact_loop(q, k, reps=2, mode=mode), x, q)
        assert (got[1].numpy()[:, 0] == tids[:, 0]).mean() >= 0.95


def test_xbin8_loop_defer(near_tie):
    x, _, _, q = near_tie
    js, ts = _pair(near_tie)
    ts.loop_rescore = js.loop_rescore = "defer"
    got = ts.exact_loop(q, 4, reps=2, mode="xbin8")
    _assert_same(got, js.exact_loop(q, 4, reps=2, mode="xbin8"), x, q)
    assert (got[1].numpy()[:, 0] == _f32_truth(x, q, 4)[:, 0]).mean() >= 0.9


def test_spilled_searcher_defer(near_tie):
    """The deferred 2k stacks on the spilled layout's 2k dedup; ids stay in
    the original space with no repeat."""
    x, _, _, q = near_tie
    js, ts = _pair(near_tie, spill=0.2)
    assert ts._emb_ref is not None
    ts.loop_rescore = js.loop_rescore = "defer"
    got = ts.search_loop(q, 4, nprobe=8, reps=2, mode="scan")
    _assert_same(got, js.search_loop(q, 4, nprobe=8, reps=2, mode="scan"), x, q)
    ids = got[1].numpy()
    assert (ids[:, 0] == _f32_truth(x, q, 4)[:, 0]).mean() >= 0.95
    for row in ids:
        kept = row[row >= 0]
        assert len(set(kept.tolist())) == len(kept)
    assert ids.max() < len(x)


@pytest.mark.parametrize("loop,mode", [("search", "binscan8"), ("search", "scan"),
                                       ("exact", "xbin8"), ("exact", "stream"),
                                       ("exact", "tilescan")])
def test_defer_is_one_rescore_of_the_2k_selection(near_tie, loop, mode):
    """A deferred loop returns the storage-precision selection of 2k (each
    re-scored against the storage rows) re-scored once against the f32
    copy and cut to k; ``cert`` refuses the deferred regime."""
    x, _, _, q = near_tie
    _, ts = _pair(near_tie)
    ts.loop_rescore = "defer"
    qt = ts._check_queries(q)
    if loop == "search":
        got = ts.search_loop(q, 4, nprobe=8, reps=3, mode=mode)
        ts._hold_ref = True
        d2, ids = ts._search_raw(qt, 8, 8, mode)
    else:
        got = ts.exact_loop(q, 4, reps=3, mode=mode)
        ts._hold_ref = True
        d2, ids = ts._exact_raw(qt, 8, mode)
    ts._hold_ref = False
    d2, ids = _refine(qt, ts._emb_ref, d2, ids, 4)
    assert torch.equal(got[1], ts._map_ids(d2, ids))
    assert torch.equal(got[0], d2.sqrt())
    with pytest.raises(ValidationError, match="cert"):
        ts.exact_loop(q, 4, reps=1, mode="cert")
