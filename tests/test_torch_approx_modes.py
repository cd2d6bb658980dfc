"""The over-fetch modes (``scan``, ``approx``, ``compact`` through the
searcher; ``exact(mode="approx")``) and the plain masked scan (``masked``)
of the port against the JAX package on the CPU, where XLA's
``approx_min_k`` is an exact top-k, as the port's selection is everywhere.

Tolerance: ids equal, except that rows whose f32 distances tie may swap;
distances within 1e-5 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pqvector_tpu_torch.query.device as tdev
from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu.query.device import _approx_min_k_clamped as j_approx_min_k_clamped
from pqvector_tpu_torch import DeviceIvfSearcher, ValidationError
from pqvector_tpu_torch.convert import (
    SEARCHER_KNOBS,
    copy_searcher_knobs,
    index_from_reference,
)

N, D, KC, TILE = 5000, 24, 20, 128


def _data(seed=2):
    rng = np.random.default_rng(seed)
    cent = rng.integers(-8, 9, (KC, D)).astype(np.float32) / 2
    x = (cent[rng.integers(0, KC, N)] + 0.4 * rng.standard_normal((N, D))).astype(np.float32)
    q = (x[rng.integers(0, N, 7)] + 0.05 * rng.standard_normal((7, D))).astype(np.float32)
    return x, q


def _pair(x, dtype="float32", sorted_=False, row_tile=TILE):
    index = j_build_ivf_index(JEmbeddings(x, D), JIvfBuildConfig(n_clusters=KC, seed=0))
    js = JSearcher(index, x, dtype=getattr(jnp, dtype), row_tile=row_tile,
                   cluster_sorted=sorted_)
    ts = DeviceIvfSearcher(
        index_from_reference(np.asarray(index.centroids), index.list_offsets,
                             index.row_ids),
        x, dtype=getattr(torch, dtype), row_tile=row_tile, cluster_sorted=sorted_,
        device="cpu")
    return js, ts


def _assert_same(got, want, x, q):
    gd, gi = got[0].numpy(), got[1].numpy()
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-7)
    for b, c in zip(*np.nonzero(gi != wi)):
        assert gi[b, c] >= 0 and wi[b, c] >= 0
        d_g = ((x[gi[b, c]] - q[b]) ** 2).sum()
        d_w = ((x[wi[b, c]] - q[b]) ** 2).sum()
        assert abs(d_g - d_w) <= 1e-5 * max(d_w, 1e-12), (b, c)


@pytest.mark.parametrize("mode", ["scan", "approx", "masked", "compact"])
@pytest.mark.parametrize("nprobe", [1, 4])
@pytest.mark.parametrize("sorted_", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_search_modes_match_jax(dtype, sorted_, nprobe, mode):
    x, q = _data()
    js, ts = _pair(x, dtype, sorted_)
    copy_searcher_knobs(js, ts)
    _assert_same(ts.search(q, 5, nprobe, mode), js.search(q, 5, nprobe, mode), x, q)


@pytest.mark.parametrize("k", [1, 10, 40, 100])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exact_approx_matches_jax_and_truth(dtype, k):
    """k = 40 and 100 take the 2k over-fetch rule; the JAX searcher chunks
    at 64 row tiles off the TPU, the port always."""
    x, q = _data(seed=3)
    js, ts = _pair(x, dtype)
    got = ts.exact(q, k, "approx")
    _assert_same(got, js.exact(q, k, "approx"), x, q)
    if dtype == "float32":
        for b in range(len(q)):
            d = ((x - q[b]) ** 2).sum(1)
            assert set(got[1].numpy()[b]) == set(np.argsort(d, kind="stable")[:k])


@pytest.mark.parametrize("overfetch", [0, 7, 300])
@pytest.mark.parametrize("mode", ["scan", "approx"])
def test_overfetch_knob_matches_jax(mode, overfetch):
    x, q = _data(seed=4)
    js, ts = _pair(x, "bfloat16", True)
    js.scan_overfetch = overfetch
    copy_searcher_knobs(js, ts)
    assert ts.scan_overfetch == overfetch
    _assert_same(ts.search(q, 5, 3, mode), js.search(q, 5, 3, mode), x, q)


def test_chunking_does_not_change_the_result(monkeypatch):
    """The selection is exact, so any chunk gives the same ids: one chunk,
    the default, and a cap that forces a chunk of one row tile."""
    x, q = _data(seed=5)
    _, ts = _pair(x, "bfloat16", True)
    assert ts._approx_chunk(7) == min(ts.emb.shape[0], 64 * TILE)
    want = ts.search(q, 5, 3, "scan")
    monkeypatch.setattr(tdev, "_APPROX_BLOCK_CAP", 7 * TILE * 4)
    assert ts._approx_chunk(7) == TILE
    for mode in ("scan", "approx", "compact"):
        got = ts.search(q, 5, 3, mode)
        if mode == "scan":
            np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
        assert (got[1] >= 0).all()
    monkeypatch.undo()
    _, ts1 = _pair(x, "bfloat16", True, row_tile=8192)  # one chunk holds every row
    _assert_same(ts1.search(q, 5, 3, "scan"), (want[0].numpy(), want[1].numpy()), x, q)


def test_bf16_scores_keep_recall():
    """``approx_score_dtype=bfloat16`` rounds the selection scores; the
    over-fetch and the f32 re-score keep the true neighbours."""
    x, q = _data(seed=6)
    js, ts = _pair(x, "bfloat16", False)
    js.approx_score_dtype = jnp.bfloat16
    copy_searcher_knobs(js, ts)
    assert ts.approx_score_dtype == torch.bfloat16
    _, ids = ts.search(q, 10, 1, "scan")
    hits = 0
    for b in range(len(q)):
        d = ((x - q[b]) ** 2).sum(1)
        hits += len(set(ids.numpy()[b]) & set(np.argsort(d, kind="stable")[:10]))
    assert hits >= 0.95 * 10 * len(q)


@pytest.mark.parametrize("k,width", [(3, 10), (10, 10), (14, 10)])
def test_approx_min_k_clamped_matches_jax(k, width):
    rng = np.random.default_rng(k)
    part = rng.integers(0, 5, (4, width)).astype(np.float32)  # ties
    v, i = tdev._approx_min_k_clamped(torch.from_numpy(part), k, 0.99)
    jv, ji = j_approx_min_k_clamped(jnp.asarray(part), k, 0.99)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


@pytest.mark.parametrize("mode", ["scan", "approx", "masked", "compact", "pallas",
                                  "stream", "auto", "binscan"])
def test_search_loop_returns_the_single_call(mode):
    x, q = _data(seed=7)
    _, ts = _pair(x, "bfloat16", True)
    d, ids = ts.search(q, 5, 3, mode)
    ld, lids = ts.search_loop(q, 5, 3, reps=3, mode=mode)
    np.testing.assert_array_equal(lids.numpy(), ids.numpy())
    np.testing.assert_array_equal(ld.numpy(), d.numpy())


@pytest.mark.parametrize("mode", ["approx", "stream", "pallas", "xla", "binscan", "auto"])
def test_exact_loop_returns_the_single_call(mode):
    x, q = _data(seed=8)
    _, ts = _pair(x)
    d, ids = ts.exact(q, 5, mode)
    ld, lids = ts.exact_loop(q, 5, reps=2, mode=mode)
    np.testing.assert_array_equal(lids.numpy(), ids.numpy())
    np.testing.assert_array_equal(ld.numpy(), d.numpy())


@pytest.mark.parametrize("mode", ["scan", "compact"])
def test_loops_match_jax_loops(mode):
    x, q = _data(seed=9)
    js, ts = _pair(x, "float32", True)
    copy_searcher_knobs(js, ts)
    want = js.search_loop(q, 5, 3, reps=2, mode=mode)
    _assert_same(ts.search_loop(q, 5, 3, reps=2, mode=mode), want, x, q)


@pytest.mark.parametrize("mode", ["xbin", "xbin8", "tilescan", "autoscan"])
def test_unported_modes_raise(mode):
    x, q = _data()
    _, ts = _pair(x)
    with pytest.raises(ValidationError, match="not ported"):
        ts.search(q, 5, 3, mode)
    with pytest.raises(ValidationError, match="not ported"):
        ts.exact(q, 5, mode)
    with pytest.raises(ValidationError, match="not ported"):
        ts.search_loop(q, 5, 3, reps=1, mode=mode)


def test_loops_reject_bad_arguments():
    x, q = _data()
    _, ts = _pair(x)
    with pytest.raises(ValidationError):
        ts.search_loop(q, 5, 3, reps=0)
    with pytest.raises(ValidationError):
        ts.exact_loop(q, 5, reps=0)
    with pytest.raises(ValidationError, match="Unknown"):
        ts.exact_loop(q, 5, reps=1, mode="compact")  # a search mode only


def test_copy_searcher_knobs_carries_every_knob():
    x, _ = _data()
    js, ts = _pair(x)
    js.approx_recall_target, js.approx_score_dtype = 0.9, jnp.bfloat16
    js.scan_overfetch, js.tilescan_tile, js.cert_fetch_tiles = 33, 64, 5
    js.cert_pass1, js.cert_pass2, js.compact_slack = "storage", "scan", 2.0
    copy_searcher_knobs(js, ts)
    for name in SEARCHER_KNOBS:
        if name != "approx_score_dtype":
            assert getattr(ts, name) == getattr(js, name), name
    assert ts.approx_score_dtype == torch.bfloat16
    js.approx_score_dtype = jnp.float32
    copy_searcher_knobs(js, ts)
    assert ts.approx_score_dtype == torch.float32


def test_search_loop_refuses_gather_as_the_jax_package_does():
    """``gather`` has no loop in the JAX package: its catalogue refuses it,
    so that a loop never times another path than the one it names. The
    port's loops take the same catalogues."""
    from pqvector_tpu.errors import ValidationError as JValidationError

    x, q = _data()
    js, ts = _pair(x, sorted_=True)
    with pytest.raises(JValidationError, match="Unknown search_loop mode 'gather'"):
        js.search_loop(q, 5, 3, reps=1, mode="gather")
    with pytest.raises(ValidationError, match="Unknown search_loop mode 'gather'"):
        ts.search_loop(q, 5, 3, reps=1, mode="gather")
    with pytest.raises(JValidationError, match="Unknown exact_loop mode 'gather'"):
        js.exact_loop(q, 5, reps=1, mode="gather")
    with pytest.raises(ValidationError, match="Unknown exact_loop mode 'gather'"):
        ts.exact_loop(q, 5, reps=1, mode="gather")
    for mode in sorted(tdev._SEARCH_LOOP_MODES - {"bincompact", "bincompact8"}):
        ts.search_loop(q, 5, 3, reps=1, mode=mode)
    for mode in sorted(tdev._EXACT_LOOP_MODES):
        ts.exact_loop(q, 5, reps=1, mode=mode)
