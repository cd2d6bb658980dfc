"""``xbin`` and ``xbin8`` (the packed-key binned-min scans, plain torch in the
port as they are plain XLA in the JAX package) against the JAX package on
the CPU.

Twins of the xbin tests of ``tests/test_device_search.py``, on its fixture:
each runs the JAX function and the port's on the same seeded numpy inputs
and holds the port to the JAX result and to the JAX test's own assertions.
Then the geometry rules (``_xbin_code_bits``, ``_xbin_bins``,
``_xbin_auto_chunk``) over a grid of shapes, and ``xbin8``'s bin keys.

Tolerance: ids equal, except that rows whose f32 distances tie within 1e-5
relative may swap at the k-th place; distances within rtol 1e-5. ``xbin8``'s
bin keys and ids are bit-equal: its dot sums are exact int32 sums in both
packages, and on rows and queries on a 1/64 grid (as the K7 twins use a
1/4 one) every norm is an exact f32 sum too, so each key is the same few
roundings of the same numbers. The JAX package's keys are read from its own
``_exact_xbin8_impl``: its jaxpr up to the ``top_k`` of the bin table.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

import pqvector_tpu.query.device as jdev
import pqvector_tpu_torch.query.device as tdev
from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch import DeviceIvfSearcher, ValidationError
from pqvector_tpu_torch.convert import index_from_reference
from pqvector_tpu_torch.kernels.binscan import PROVENANCE_BITS_MAX


def _pair_of(x, n_clusters, seed, **kw):
    jindex = j_build_ivf_index(JEmbeddings(x, x.shape[1]),
                               JIvfBuildConfig(n_clusters=n_clusters, seed=seed))
    index = index_from_reference(np.asarray(jindex.centroids), jindex.list_offsets,
                                 jindex.row_ids)
    jkw = {k: getattr(jnp, v) if k == "dtype" else v for k, v in kw.items()}
    tkw = {k: getattr(torch, v) if k == "dtype" else v for k, v in kw.items()}
    return JSearcher(jindex, x, **jkw), DeviceIvfSearcher(index, x, device="cpu", **tkw)


@pytest.fixture(scope="module")
def setup():
    """The JAX test's fixture: 500 x 16, IVF-10 (seed 3), row_tile 128."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((500, 16)).astype(np.float32)
    js, ts = _pair_of(x, 10, 3, row_tile=128)
    queries = rng.standard_normal((7, 16)).astype(np.float32)
    return x, js, ts, queries


def brute_force(x, q, k):
    d = ((x - q[None, :]) ** 2).sum(1)
    idx = np.argsort(d, kind="stable")[:k]
    return idx, np.sqrt(d[idx])


def _np(res):
    return tuple(r.numpy() if isinstance(r, torch.Tensor) else np.asarray(r) for r in res)


def _assert_same(got, want, x, q):
    """(distances, ids) of the port against the JAX package's."""
    gd, gi = _np(got)
    wd, wi = _np(want)
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-7)
    for b, c in zip(*np.nonzero(gi != wi)):
        assert gi[b, c] >= 0 and wi[b, c] >= 0
        d_g = ((x[gi[b, c]] - q[b]) ** 2).sum()
        d_w = ((x[wi[b, c]] - q[b]) ** 2).sum()
        assert abs(d_g - d_w) <= 1e-5 * max(d_w, 1e-12), (b, c)


def test_xbin_mode_matches_exact(setup):
    """One tile group (nt = 1) at this size: collision-free, so ``xbin``
    equals the exact scan through every entry point; nprobe is ignored."""
    x, js, ts, queries = setup
    assert ts.can_xbin(5) and js.can_xbin(5)
    de, ie = ts.exact(queries, k=5)
    d1, i1 = ts.search(queries, k=5, nprobe=1, mode="xbin")
    np.testing.assert_array_equal(i1.numpy(), ie.numpy())
    np.testing.assert_allclose(d1.numpy(), de.numpy(), rtol=1e-5)
    _assert_same((d1, i1), js.search(queries, k=5, nprobe=1, mode="xbin"), x, queries)
    _assert_same(ts.exact(queries, k=5, mode="xbin"),
                 js.exact(queries, k=5, mode="xbin"), x, queries)
    _, il = ts.search_loop(queries, k=5, nprobe=1, reps=2, mode="xbin")
    np.testing.assert_array_equal(il.numpy(), ie.numpy())
    _, il = ts.exact_loop(queries, k=5, reps=2, mode="xbin")
    np.testing.assert_array_equal(il.numpy(), ie.numpy())


def test_xbin_multi_tile_provenance(setup):
    """128 bins (nt = 4): the packed keys decode to distinct real rows with
    exact distances, ascending, and only bin collisions lose recall."""
    x, js, ts, queries = setup
    n_pad = int(ts.emb.shape[0])
    assert n_pad % 128 == 0 and n_pad // 128 > 1
    got = tdev._exact_xbin_impl(ts._check_queries(queries), ts.emb, ts.emb_sq, 5, 128)
    want = jdev._exact_xbin_impl(js._check_queries(queries), js.emb, js.emb_sq, k=5,
                                 l_bins=128)
    _assert_same(got, want, x, queries)
    d2, ids = _np(got)
    hits = 0
    for b, q in enumerate(queries):
        want_ids, _ = brute_force(x, q, 5)
        row = ids[b][ids[b] >= 0]
        assert len(set(row.tolist())) == len(row)
        np.testing.assert_allclose(d2[b][: len(row)], ((x[row] - q) ** 2).sum(1), rtol=1e-4)
        assert np.all(np.diff(d2[b]) >= -1e-5)
        hits += len(set(row.tolist()) & set(want_ids.tolist()))
    assert hits >= 0.8 * queries.shape[0] * 5


def test_xbin_chunked_matches_unchunked(setup):
    """Blocks of tile groups fold the same keys through a running min: the
    same selection for any divisor, a non-divisor clamped to the largest
    divisor below it; through the searcher's knob as well."""
    x, js, ts, queries = setup
    q = ts._check_queries(queries)
    ref_d, ref_i = tdev._exact_xbin_impl(q, ts.emb, ts.emb_sq, 5, 128)
    nt = int(ts.emb.shape[0]) // 128
    assert nt > 1
    for g in (1, 2, nt - 1, nt):
        d2, ids = tdev._exact_xbin_impl(q, ts.emb, ts.emb_sq, 5, 128, chunk_groups=g)
        assert torch.equal(ids, ref_i)
        np.testing.assert_allclose(d2.numpy(), ref_d.numpy(), rtol=1e-6)
        _assert_same((d2, ids), jdev._exact_xbin_impl(
            js._check_queries(queries), js.emb, js.emb_sq, k=5, l_bins=128,
            chunk_groups=g), x, queries)
    _, i0 = ts.search(queries, k=5, nprobe=1, mode="xbin")
    ts.xbin_chunk_groups = js.xbin_chunk_groups = 2
    try:
        _, i1 = ts.search(queries, k=5, nprobe=1, mode="xbin")
        il = ts.exact_loop(queries, k=5, reps=2, mode="xbin")
        _assert_same(il, js.exact_loop(queries, k=5, reps=2, mode="xbin"), x, queries)
    finally:
        ts.xbin_chunk_groups = js.xbin_chunk_groups = 0
    assert torch.equal(i1, i0) and torch.equal(il[1], i0)


@pytest.mark.parametrize("n_pad", [128, 512, 640, 1000, 4096, 1_003_520, 128 * (1 << 17),
                                   10_002_432])
@pytest.mark.parametrize("k", [1, 10, 200, 100_000])
def test_xbin_geometry_matches_jax(n_pad, k):
    """``_xbin_bins`` and ``_xbin_code_bits`` are the JAX package's rules."""
    assert tdev._xbin_bins(n_pad, k) == jdev._xbin_bins(n_pad, k)
    for l_bins in (1, 128, 512, 4096):
        if n_pad % l_bins == 0:
            assert tdev._xbin_code_bits(n_pad, l_bins) == jdev._xbin_code_bits(n_pad, l_bins)


def test_xbin_provenance_cap():
    """Tile codes share binscan's provenance budget: auto skips a bin count
    whose code bits pass it, an explicit one raises."""
    from types import SimpleNamespace

    n_pad = 128 * (1 << 17)
    assert tdev._xbin_code_bits(n_pad, 128) == 17 > PROVENANCE_BITS_MAX
    lb = tdev._xbin_bins(n_pad, 10)
    assert lb > 0 and tdev._xbin_code_bits(n_pad, lb) <= PROVENANCE_BITS_MAX
    fake = SimpleNamespace(emb=np.empty((n_pad, 0)), xbin_bins=128)
    with pytest.raises(ValidationError, match="provenance bits"):
        DeviceIvfSearcher._xbin_bins_checked(fake, 10)


@pytest.mark.parametrize("b", [1, 256, 4096])
@pytest.mark.parametrize("chunk_groups", [-1, 0, 7])
def test_xbin_auto_chunk_matches_jax(b, chunk_groups):
    for n_pad, l_bins in ((1_003_520, 62720), (10_002_432, 39072), (512, 128)):
        assert tdev._xbin_auto_chunk(b, n_pad, l_bins, chunk_groups) == \
            jdev._xbin_auto_chunk(b, n_pad, l_bins, chunk_groups)


def test_xbin_auto_chunk_policy(setup, monkeypatch):
    """``xbin_chunk_groups=0`` is a policy: one call within the budget,
    bounded steps beyond it, -1 forces one call; the ids do not change."""
    assert tdev._xbin_auto_chunk(4096, 1_003_520, 62720, 7) == 7
    assert tdev._xbin_auto_chunk(4096, 1_003_520, 62720, -1) == 0
    assert tdev._xbin_auto_chunk(256, 1_003_520, 62720, 0) == 0
    g = tdev._xbin_auto_chunk(4096, 1_003_520, 62720, 0)
    assert g >= 1 and 4096 * g * 62720 * 4 <= tdev._XBIN_FUSE_BUDGET

    x, js, ts, queries = setup
    _, i_fused = ts.search(queries, k=5, nprobe=1, mode="xbin")
    monkeypatch.setattr(tdev, "_XBIN_FUSE_BUDGET", 1024)
    monkeypatch.setattr(jdev, "_XBIN_FUSE_BUDGET", 1024)
    ts.xbin_chunk_groups = -1
    try:
        _, i_forced = ts.search(queries, k=5, nprobe=1, mode="xbin")
        ts.xbin_chunk_groups = 0
        _, i_auto = ts.search(queries, k=5, nprobe=1, mode="xbin")
        loop = ts.search_loop(queries, k=5, nprobe=1, reps=2, mode="xbin")
        _assert_same(loop, js.search_loop(queries, k=5, nprobe=1, reps=2, mode="xbin"),
                     x, queries)
    finally:
        ts.xbin_chunk_groups = 0
    for ids in (i_forced, i_auto, loop[1]):
        assert torch.equal(ids, i_fused)


def test_xbin8_mode_recall_and_exact_distances(setup):
    """``xbin8``: selection may differ from the exact scan by quantization
    races, but the distances are exact (re-scored), ascending, recall high
    at the default 4k fetch, and the loops give the same ids."""
    x, js, ts, queries = setup
    assert ts.can_xbin(5)
    _, ie = ts.exact(queries, k=5)
    d8, i8 = ts.search(queries, k=5, nprobe=1, mode="xbin8")
    np.testing.assert_array_equal(i8.numpy(),
                                  np.asarray(js.search(queries, k=5, nprobe=1, mode="xbin8")[1]))
    i8, d8 = i8.numpy(), d8.numpy()
    hits = sum(len(set(a.tolist()) & set(b.tolist())) for a, b in zip(i8, ie.numpy()))
    assert hits / ie.numel() >= 0.9
    for b in range(len(queries)):
        want = np.sqrt(((x[i8[b]] - queries[b]) ** 2).sum(1))
        np.testing.assert_allclose(d8[b], want, rtol=1e-4, atol=1e-4)
        assert np.all(np.diff(d8[b]) >= -1e-6)
    _, il = ts.search_loop(queries, k=5, nprobe=1, reps=2, mode="xbin8")
    np.testing.assert_array_equal(il.numpy(), i8)
    _, il = ts.exact_loop(queries, k=5, reps=2, mode="xbin8")
    np.testing.assert_array_equal(il.numpy(), i8)


def test_xbin8_quantization_unit():
    """Per-row symmetric int8 codes: within 1/254 of the row's largest
    magnitude, zero rows stay zero with scale 1; bit-equal to the JAX
    package's codes and scales."""
    rng = np.random.default_rng(5)
    x = np.vstack([rng.standard_normal((20, 8)).astype(np.float32) * 10.0,
                   np.zeros((4, 8), np.float32)])
    qi, s = (t.numpy() for t in tdev._quantize_rows_i8(torch.from_numpy(x)))
    jqi, js_ = (np.asarray(a) for a in jdev._quantize_rows_i8(jnp.asarray(x)))
    np.testing.assert_array_equal(qi, jqi)
    np.testing.assert_array_equal(s, js_)
    recon = qi.astype(np.float32) * s[:, None]
    np.testing.assert_allclose(recon, x, atol=float(np.abs(x).max()) / 253)
    assert np.all(qi[20:] == 0) and np.all(s[20:] == 1.0)
    assert np.abs(qi).max() <= 127


def test_xbin8_chunked_matches_unchunked(setup):
    x, js, ts, queries = setup
    d0, i0 = ts.search(queries, k=5, nprobe=1, mode="xbin8")
    ts.xbin_chunk_groups = js.xbin_chunk_groups = 1
    try:
        d1, i1 = ts.search(queries, k=5, nprobe=1, mode="xbin8")
        _assert_same((d1, i1), js.search(queries, k=5, nprobe=1, mode="xbin8"), x, queries)
    finally:
        ts.xbin_chunk_groups = js.xbin_chunk_groups = 0
    assert torch.equal(i1, i0)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), rtol=1e-6)


def _grid(n, d, seed, b=6):
    """Rows and queries on a 1/64 grid within [-4, 4]: every norm and dot
    product is an exact f32 sum, and distinct rows rarely tie."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-256, 257, (n, d)).astype(np.float32) / 64.0
    q = x[rng.integers(0, n, b)] + rng.integers(-8, 9, (b, d)).astype(np.float32) / 64.0
    return x, q


def _jax_bin_keys(impl, *args, **static):
    """The JAX scan's [B, l_bins] bin-key table: its jaxpr up to the first
    ``top_k``, whose operand is the negated table, run under jit."""
    fn = functools.partial(impl, **static)
    closed = jax.make_jaxpr(fn)(*args)
    names = [e.primitive.name for e in closed.jaxpr.eqns]
    cut = names.index("top_k")
    head = closed.jaxpr.replace(eqns=closed.jaxpr.eqns[:cut],
                                outvars=[closed.jaxpr.eqns[cut].invars[0]], debug_info=None)
    (neg,) = jax.jit(jcore.jaxpr_as_fun(jcore.ClosedJaxpr(head, closed.consts)))(*args)
    return -np.asarray(neg)


# the truncated jaxpr carries no debug info, which jax warns about
@pytest.mark.filterwarnings("ignore:core.Jaxpr is missing a DebugInfo:DeprecationWarning")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l_bins,chunk_groups", [(512, 0), (128, 0), (128, 1), (128, 3)])
def test_xbin8_keys_and_ids_bit_equal_jax(dtype, l_bins, chunk_groups):
    """The bin-key table and the ids of ``xbin8`` equal the JAX package's bit
    for bit, unchunked and in blocks of tile groups."""
    x, q = _grid(1500, 24, seed=3)
    js, ts = _pair_of(x, 6, 0, row_tile=128, dtype=dtype)
    je8, jsc = js._xbin8_arrays()
    te8, tsc = ts._xbin8_arrays()
    np.testing.assert_array_equal(te8.numpy(), np.asarray(je8))
    jq, tq = js._check_queries(q), ts._check_queries(q)
    jargs = (jq, je8, jsc, js.emb_sq, js._ref_or_emb())
    want = _jax_bin_keys(jdev._exact_xbin8_impl, *jargs, k=5, l_bins=l_bins,
                         chunk_groups=chunk_groups)
    got = {}
    real = tdev._topk_min_wide

    def spy(keys, m):
        got["keys"] = keys.clone()
        return real(keys, m)

    tdev._topk_min_wide = spy
    try:
        d2, ids = tdev._exact_xbin8_impl(tq, te8, tsc, ts.emb_sq, ts._ref_or_emb(), 5,
                                         l_bins, chunk_groups=chunk_groups)
    finally:
        tdev._topk_min_wide = real
    np.testing.assert_array_equal(got["keys"].numpy(), want)
    jd2, jids = jdev._exact_xbin8_impl(*jargs, k=5, l_bins=l_bins, chunk_groups=chunk_groups)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6)


@pytest.mark.parametrize("dtype,score_dtype", [("float32", "float32"),
                                               ("bfloat16", "float32"),
                                               ("bfloat16", "bfloat16")])
def test_xbin_storage_and_score_dtypes_match_jax(dtype, score_dtype):
    """bf16 storage with its f32 copy and bf16 selection scores: the same
    winners, re-scored in f32, as the JAX package."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2000, 32)).astype(np.float32)
    q = (x[rng.integers(0, 2000, 9)] + 0.05 * rng.standard_normal((9, 32))).astype(np.float32)
    js, ts = _pair_of(x, 12, 1, row_tile=256, dtype=dtype)
    js.approx_score_dtype = getattr(jnp, score_dtype)
    ts.approx_score_dtype = getattr(torch, score_dtype)
    for mode in ("xbin", "xbin8"):
        _assert_same(ts.search(q, 10, 1, mode), js.search(q, 10, 1, mode), x, q)
