"""The port's sharded build and searchers (``pqvector_tpu_torch/dist``)
against the JAX package's ``dist/`` on the CPU.

Twins of ``tests/test_dist.py``, one for each of its tests: the same numpy
inputs go through the JAX package on the eight virtual CPU devices of
``tests/conftest.py`` and through the port on ``make_mesh(8,
device="cpu")``, a one-process mesh that names the CPU eight times. Each
twin holds the port to the JAX package's result and to the JAX test's own
assertions.

Tolerances: ids equal; f32 distances within rtol 1e-5, atol 1e-5;
centroids within 2e-5 (sums added in another order); bf16 storage at the
JAX test's 4-of-5 overlap.
"""

import jax
import numpy as np
import pytest
import torch

from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu import dist as jdist
from pqvector_tpu.index.kmeans import _lloyd as j_lloyd
from pqvector_tpu.index.kmeans import _pad_rows as j_pad_rows
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch import DeviceIvfSearcher, Embeddings, IvfBuildConfig, ValidationError
from pqvector_tpu_torch import build_ivf_index, dist
from pqvector_tpu_torch.convert import dist_searcher_state_from_reference, index_from_reference
from pqvector_tpu_torch.dist import kmeans as kmeans_mod
from pqvector_tpu_torch.dist import mesh as mesh_mod
from pqvector_tpu_torch.dist import search as search_mod
from pqvector_tpu_torch.index import kmeans as tkm

CPU = "cpu"


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jdist.make_mesh(8)


@pytest.fixture(scope="module")
def mesh():
    return dist.make_mesh(8, device=CPU)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    centers = rng.uniform(-5, 5, (6, 8)).astype(np.float32)
    return np.concatenate(
        [c + 0.1 * rng.standard_normal((40, 8)).astype(np.float32) for c in centers]
    )


def _indexes(x, n_clusters, seed):
    """(JAX index, the port's copy of it)."""
    jindex = j_build_ivf_index(
        JEmbeddings(x, x.shape[1]), JIvfBuildConfig(n_clusters=n_clusters, seed=seed)
    )
    index = index_from_reference(np.asarray(jindex.centroids), jindex.list_offsets,
                                 jindex.row_ids)
    return jindex, index


@pytest.fixture(scope="module")
def idx1(data):
    return _indexes(data, 6, 1)


@pytest.fixture(scope="module")
def idx0(data):
    return _indexes(data, 6, 0)


@pytest.fixture(scope="module")
def ivf8(jmesh, mesh, data, idx1):
    """(JAX, port) searchers over IVF-6 (seed 1), tile 8, eight shards."""
    jindex, index = idx1
    return (jdist.DistributedIvfSearcher(jindex, data, mesh=jmesh, tile=8),
            dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=8))


@pytest.fixture(scope="module")
def exact64(jmesh, mesh, data):
    return (jdist.DistributedExactSearcher(data, mesh=jmesh, row_tile=64),
            dist.DistributedExactSearcher(data, mesh=mesh, row_tile=64))


def _same(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=rtol, atol=atol)


def _hits(a, b):
    return sum(len(set(x.tolist()) & set(y.tolist())) for x, y in zip(a, b))


def _distinct_originals(ids, n):
    for r in ids:
        live = [v for v in r.tolist() if v >= 0]
        assert len(set(live)) == len(live)
        assert all(v < n for v in live)


# ----------------------------------------------------------------------
# The mesh
# ----------------------------------------------------------------------


def test_make_mesh_without_a_card_raises():
    """``device=None`` takes CUDA devices and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.make_mesh(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.make_mesh_2d(2, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.DistributedExactSearcher(np.zeros((8, 4), np.float32))


def test_mesh_shapes_collectives_and_placement():
    m = dist.make_mesh(4, device=CPU)
    assert m.size == 4 and m.axis_names == (dist.DATA_AXIS,) and m.shape == (4,)
    m2 = dist.make_mesh_2d(2, 3, device=CPU)
    assert m2.shape == (2, 3) and m2.axis_names == (dist.DATA_AXIS, dist.CLUSTER_AXIS)
    assert m2.size == 6
    with pytest.raises(ValueError):
        dist.make_mesh(0, device=CPU)
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    parts = dist.shard_rows(x, m)
    assert [p.shape for p in parts] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), x)
    with pytest.raises(ValueError):
        dist.shard_rows(x[:7], m)
    reps = dist.replicate(x, m)
    assert all(r is reps[0] for r in reps)  # one device: one shared copy
    gathered = mesh_mod.all_gather(parts, m)
    assert gathered.shape == (4, 2, 3)
    np.testing.assert_array_equal(gathered.numpy().reshape(8, 3), x)
    # psum adds the terms in shard order, then term order, from zero, and
    # hands the total to every shard
    vals = [[torch.tensor([1e8], dtype=torch.float32), torch.tensor([1.0])], [],
            [torch.tensor([-1e8])], [torch.tensor([1.0])]]
    total = mesh_mod.psum(vals, m)
    want = ((np.float32(1e8) + np.float32(1.0)) + np.float32(-1e8)) + np.float32(1.0)
    assert len(total) == 4 and all(float(t) == float(want) for t in total)


def test_shard_work_runs_in_each_shards_device_scope(monkeypatch, data, idx1):
    """Every shard's kernel call happens inside ``device_scope`` of that
    shard's device, with that shard's tensors (on a card, the scope makes it
    the current device, so a launch goes there)."""
    _, index = idx1
    m = dist.make_mesh(4, device=CPU)
    s = dist.DistributedIvfSearcher(index, data, mesh=m, tile=8)
    entered = []
    real_scope = mesh_mod.device_scope

    class Recorder:
        def __init__(self, dev):
            self.dev = dev

        def __enter__(self):
            entered.append(self.dev)
            return real_scope(self.dev).__enter__()

        def __exit__(self, *exc):
            entered.append(None)
            return False

    calls = []
    real_k3 = search_mod.stream_masked_topk

    def k3(q, centroids, c_sq, offsets, emb, *args, **kwargs):
        calls.append((len(entered), entered[-1] if entered else None, emb))
        return real_k3(q, centroids, c_sq, offsets, emb, *args, **kwargs)

    monkeypatch.setattr(search_mod, "device_scope", Recorder)
    monkeypatch.setattr(search_mod, "stream_masked_topk", k3)
    s.search_fused(data[:3], k=4, nprobe=3)
    assert len(calls) == m.size
    for shard, (depth, dev, emb) in enumerate(calls):
        assert dev == m.devices[shard]  # inside a scope, not after its exit
        assert emb is s.emb[shard]
        assert emb.device == dev
    assert entered.count(None) == m.size  # every scope was left


# ----------------------------------------------------------------------
# Twins of tests/test_dist.py
# ----------------------------------------------------------------------


def test_distributed_lloyd_matches_jax_and_single_chip(jmesh, mesh, data):
    k = 6
    rng = np.random.default_rng(0)
    c0 = data[rng.choice(len(data), k, replace=False)].copy()
    x_pad, w = j_pad_rows(jax.numpy.asarray(data), 16)
    c_single, a_single = j_lloyd(x_pad, w, jax.numpy.asarray(c0), 10, 16, k)
    jc, ja = jdist.distributed_lloyd(data, c0, 10, mesh=jmesh, block_rows=16)
    c, a = dist.distributed_lloyd(data, c0, 10, mesh=mesh, block_rows=16)
    np.testing.assert_allclose(c, jc, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_allclose(c, np.asarray(c_single), rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(a, np.asarray(a_single)[: len(data)])


def test_distributed_exact_matches_jax_and_brute_force(jmesh, mesh, data):
    queries = data[[3, 77, 200]] + 0.01
    got = dist.DistributedExactSearcher(data, mesh=mesh, row_tile=8).search(queries, k=5)
    want = jdist.DistributedExactSearcher(data, mesh=jmesh, row_tile=8).search(queries, k=5)
    _same(got, want)
    for b, q in enumerate(queries):
        d = ((data - q[None, :]) ** 2).sum(1)
        top = np.argsort(d, kind="stable")[:5]
        np.testing.assert_array_equal(got[1][b], top)
        np.testing.assert_allclose(got[0][b], np.sqrt(d[top]), rtol=1e-4, atol=1e-4)


def test_distributed_ivf_matches_jax_and_single_device(data, idx1, ivf8):
    jindex, index = idx1
    jd, td = ivf8
    single = DeviceIvfSearcher(index, data, row_tile=64, device=CPU)
    jsingle = JSearcher(jindex, data, row_tile=64)
    queries = data[[10, 99, 230]]
    for nprobe in (1, 3, 6):
        got = td.search(queries, k=4, nprobe=nprobe)
        _same(got, jd.search(queries, k=4, nprobe=nprobe))
        _same(got, jsingle.search(queries, k=4, nprobe=nprobe), rtol=1e-4, atol=1e-4)
        d_s, i_s = single.search(queries, k=4, nprobe=nprobe)
        _same(got, (d_s.numpy(), i_s.numpy()), rtol=1e-4, atol=1e-4)


def test_distributed_ivf_k_exceeds_candidates(data, ivf8):
    jd, td = ivf8
    dists, ids = td.search(data[0], k=120, nprobe=1)
    _same((dists, ids), jd.search(data[0], k=120, nprobe=1))
    valid = (ids[0] >= 0).sum()
    assert 0 < valid < 120
    assert np.all(np.isinf(dists[0][ids[0] == -1]))


def _both_builds(x, cfg_kwargs, jmesh, mesh):
    emb = Embeddings(x, x.shape[1])
    got = dist.build_ivf_index_distributed(emb, IvfBuildConfig(**cfg_kwargs), mesh=mesh)
    want = jdist.build_ivf_index_distributed(
        JEmbeddings(x, x.shape[1]), JIvfBuildConfig(**cfg_kwargs), mesh=jmesh)
    np.testing.assert_allclose(got.centroids, np.asarray(want.centroids),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.row_ids, want.row_ids)
    np.testing.assert_array_equal(got.list_offsets, want.list_offsets)
    return got


def test_distributed_build_matches_jax_and_single_chip(jmesh, mesh, data):
    cfg = dict(n_clusters=6, seed=5, block_rows=16)
    got = _both_builds(data, cfg, jmesh, mesh)
    single = build_ivf_index(Embeddings(data, 8), IvfBuildConfig(**cfg), device=CPU)
    np.testing.assert_allclose(got.centroids, single.centroids, rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got.row_ids, single.row_ids)
    np.testing.assert_array_equal(got.list_offsets, single.list_offsets)


def test_distributed_build_matches_jax_on_data_without_clusters(jmesh, mesh):
    """Where the seeding decides the index (no clusters, few iterations),
    the port's distributed build gives the JAX distributed build's. Its init
    key ``split(PRNGKey(seed))[1]`` is the single build's
    ``split(PRNGKey(seed), 3)[1]`` under partitionable threefry, so the two
    builds differ only where the single build caps the init sample (50k of
    a training sample above it)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1000, 8)).astype(np.float32)
    cfg = dict(n_clusters=10, seed=3, block_rows=64, max_iters=1)
    got = _both_builds(x, cfg, jmesh, mesh)
    single = build_ivf_index(Embeddings(x, 8), IvfBuildConfig(**cfg), device=CPU)
    np.testing.assert_allclose(got.centroids, single.centroids, rtol=2e-5, atol=2e-5)


def test_distributed_exact_bf16(jmesh, mesh):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((240, 8)).astype(np.float32)
    q = x[[5]]
    dists, ids = dist.DistributedExactSearcher(
        x, mesh=mesh, row_tile=8, dtype=torch.bfloat16).search(q, k=5)
    _, jids = jdist.DistributedExactSearcher(
        x, mesh=jmesh, row_tile=8, dtype=jax.numpy.bfloat16).search(q, k=5)
    d = ((x - q[0]) ** 2).sum(1)
    want = set(np.argsort(d)[:5].tolist())
    assert ids[0][0] == 5
    assert len(set(ids[0].tolist()) & want) >= 4
    assert len(set(ids[0].tolist()) & set(np.asarray(jids)[0].tolist())) >= 4
    # the f32 re-score: returned distances are the f32 ones of those rows
    np.testing.assert_allclose(dists[0], np.sqrt(d[ids[0]]), rtol=1e-5, atol=1e-5)


def test_distributed_fused_matches_gather_and_jax(data, ivf8):
    jd, td = ivf8
    queries = data[[10, 99, 230]]
    for nprobe in (1, 3, 6):
        got = td.search_fused(queries, k=4, nprobe=nprobe)
        _same(got, td.search(queries, k=4, nprobe=nprobe))
        _same(got, jd.search_fused(queries, k=4, nprobe=nprobe))


def test_distributed_fused_loop_matches_single_call(data, ivf8):
    jd, td = ivf8
    queries = data[[5, 77]]
    d1, i1 = td.search_fused(queries, k=3, nprobe=2)
    dl, il = td.search_loop(queries, k=3, nprobe=2, reps=2)
    np.testing.assert_array_equal(il, i1)
    np.testing.assert_allclose(dl, d1, rtol=1e-5)
    _same((dl, il), jd.search_loop(queries, k=3, nprobe=2, reps=2))
    with pytest.raises(ValidationError, match="reps"):
        td.search_loop(queries, k=3, nprobe=2, reps=0)


def test_distributed_fused_device_count_invariant(data, idx1):
    jindex, index = idx1
    queries = data[[1, 150]]
    results = [
        dist.DistributedIvfSearcher(index, data, mesh=dist.make_mesh(n, device=CPU),
                                    tile=8).search_fused(queries, k=4, nprobe=3)
        for n in (2, 8)
    ]
    np.testing.assert_array_equal(results[0][1], results[1][1])
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-5)
    want = jdist.DistributedIvfSearcher(jindex, data, mesh=jdist.make_mesh(2), tile=8)
    _same(results[0], want.search_fused(queries, k=4, nprobe=3))


def test_distributed_scan_matches_exact_and_jax(jmesh, mesh, data, idx0, exact64):
    jindex, index = idx0
    rng = np.random.default_rng(3)
    queries = rng.standard_normal((5, 8)).astype(np.float32)
    de, ie = exact64[1].search(queries, k=4)
    _same((de, ie), exact64[0].search(queries, k=4))
    td = dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=64)
    jd = jdist.DistributedIvfSearcher(jindex, data, mesh=jmesh, tile=64)
    got = td.search_scan(queries, k=4)
    _same(got, (de, ie))
    _same(got, jd.search_scan(queries, k=4))
    np.testing.assert_array_equal(td.search_scan(queries, k=4, reps=2)[1], ie)
    do = td.search_scan(queries, k=4, overfetch=8)
    _same(do, (de, ie))
    _same(do, jd.search_scan(queries, k=4, overfetch=8))


def test_distributed_xbin_matches_exact_and_jax(jmesh, mesh, data, idx0, exact64):
    """One tile group a shard (the auto bins are the shard's rows): the
    selection is collision-free, so the ids are the sharded exact
    searcher's and the JAX package's, chained too; explicit bins with the
    chunked accumulator give valid rows, the JAX package's; a bin count that
    does not divide the shard's rows raises in both."""
    jindex, index = idx0
    rng = np.random.default_rng(5)
    queries = rng.standard_normal((5, 8)).astype(np.float32)
    de, ie = exact64[1].search(queries, k=4)
    td = dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=64)
    jd = jdist.DistributedIvfSearcher(jindex, data, mesh=jmesh, tile=64)
    assert td.can_xbin(4) and jd.can_xbin(4)
    got = td.search_xbin(queries, k=4)
    np.testing.assert_array_equal(got[1], ie)
    np.testing.assert_allclose(got[0], de, rtol=1e-5, atol=1e-5)
    _same(got, jd.search_xbin(queries, k=4))
    np.testing.assert_array_equal(td.search_xbin(queries, k=4, reps=2)[1], ie)
    lb = td._rows_per_dev // 2
    got = td.search_xbin(queries, k=4, l_bins=lb, chunk_groups=1)
    assert all(0 <= g < data.shape[0] for g in got[1].ravel().tolist() if g >= 0)
    _same(got, jd.search_xbin(queries, k=4, l_bins=lb, chunk_groups=1))
    with pytest.raises(ValidationError):
        td.search_xbin(queries, k=4, l_bins=7)


def test_cluster_axis_matches_the_row_sharded_path(data, idx1, ivf8):
    """2-D mesh probe fan-out: ids of the JAX package's (and the port's)
    1-D fused path, for the JAX test's mesh shapes."""
    _, index = idx1
    jd, td = ivf8
    queries = data[[10, 99, 230]]
    want = {nprobe: jd.search_fused(queries, k=4, nprobe=nprobe) for nprobe in (1, 3, 6)}
    for shape in ((2, 4), (1, 8), (8, 1)):
        c2 = dist.DistributedClusterIvfSearcher(
            index, data, mesh=dist.make_mesh_2d(*shape, device=CPU), tile=8)
        assert (c2._R, c2._C) == shape
        for nprobe, w in want.items():
            got = c2.search(queries, k=4, nprobe=nprobe)
            _same(got, w, rtol=1e-4, atol=1e-4)
            _same(got, td.search_fused(queries, k=4, nprobe=nprobe), rtol=1e-4, atol=1e-4)


def test_cluster_axis_loop_matches_single_call(data, idx1, ivf8):
    _, index = idx1
    c2 = dist.DistributedClusterIvfSearcher(
        index, data, mesh=dist.make_mesh_2d(2, 4, device=CPU), tile=8)
    queries = data[[5, 77]]
    d1, i1 = c2.search(queries, k=3, nprobe=2)
    dl, il = c2.search_loop(queries, k=3, nprobe=2, reps=2)
    np.testing.assert_array_equal(il, i1)
    np.testing.assert_allclose(dl, d1, rtol=1e-5)
    _same((d1, i1), ivf8[0].search_fused(queries, k=3, nprobe=2), rtol=1e-4, atol=1e-4)


def test_distributed_binscan_matches_exact_and_jax(jmesh, mesh, data, idx0, exact64):
    jindex, index = idx0
    rng = np.random.default_rng(4)
    queries = rng.standard_normal((5, 8)).astype(np.float32)
    de, ie = exact64[1].search(queries, k=4)
    td = dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=128)
    jd = jdist.DistributedIvfSearcher(jindex, data, mesh=jmesh, tile=128)
    assert td.can_binscan(4) == jd.can_binscan(4) is True
    got = td.search_binscan(queries, k=4)
    _same(got, (de, ie))
    _same(got, jd.search_binscan(queries, k=4))
    np.testing.assert_array_equal(td.search_binscan(queries, k=4, reps=2)[1], ie)


def test_distributed_assign_is_one_lloyd_iterations_assignment(jmesh, mesh, data):
    """The sharded build's last pass: the assignment one Lloyd iteration
    makes (the JAX package's ``distributed_lloyd(max_iters=1)``), on 8 and
    3 shards, equal to the plain nearest-centroid ids."""
    rng = np.random.default_rng(3)
    c = data[rng.choice(len(data), 6, replace=False)] + 0.05
    want = jdist.distributed_lloyd(data, c, 1, mesh=jmesh, block_rows=16)[1]
    for m in (mesh, dist.make_mesh(3, device=CPU)):
        got = kmeans_mod.distributed_assign(data, c, mesh=m, block_rows=16)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, dist.distributed_lloyd(
            data, c, 1, mesh=m, block_rows=16)[1])
    d2 = ((data[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(want, d2.argmin(1))


def test_distributed_lloyd_makes_no_sums_on_its_exit_iteration(monkeypatch, mesh, data):
    """From converged centroids the first iteration moves every row off the
    all-zero start (an update, its block sums on each shard) and the second
    changes nothing: it exits before any block sum is made, as ``_lloyd``
    does."""
    rng = np.random.default_rng(0)
    c0 = data[rng.choice(len(data), 6, replace=False)].copy()
    conv, _ = dist.distributed_lloyd(data, c0, 50, mesh=mesh, block_rows=16)
    calls = []
    real = kmeans_mod._block_sums
    monkeypatch.setattr(kmeans_mod, "_block_sums",
                        lambda *a: calls.append(1) or real(*a))
    c, a = dist.distributed_lloyd(data, conv, 50, mesh=mesh, block_rows=16)
    assert len(calls) == mesh.size
    assert c.tobytes() == conv.tobytes()


def test_bincompact_selection_orders_tiles_by_popularity():
    """A shard's K8 tiles below its tile count: the ``cap`` tiles that most
    queries probe (a cluster of the tile among a query's ``nprobe``
    nearest), ties in tile order; a search over them equals the JAX
    package's at that cap."""
    rng = np.random.default_rng(12)
    n, d = 2048, 8
    centers = rng.uniform(-8, 8, (8, d)).astype(np.float32)
    x = (centers[rng.integers(0, 8, n)] + 0.1 * rng.standard_normal((n, d))).astype(
        np.float32)
    jindex, index = _indexes(x, 8, 0)
    td = dist.DistributedIvfSearcher(index, x, mesh=dist.make_mesh(2, device=CPU), tile=128)
    jd = jdist.DistributedIvfSearcher(jindex, x, mesh=jdist.make_mesh(2), tile=128)
    queries = (x[rng.integers(0, n, 16)] + 0.02 * rng.standard_normal((16, d))).astype(
        np.float32)
    q = torch.from_numpy(queries)
    nprobe, cap = 2, td._nt_local // 2
    for s in range(2):
        d2 = (td.c_sq[s][None, :] - 2.0 * (q @ td.centroids[s].T)).numpy()
        probe = np.argsort(d2, axis=1, kind="stable")[:, :nprobe]
        counts = np.bincount(probe.ravel(), minlength=8 + 1)
        counts[8] = 0
        pop = counts[td._tc_host[s]].max(axis=1)
        want = np.argsort(np.where(pop > 0, -pop, 1), kind="stable")[:cap]
        sel = td._bincompact_sel(s, q, nprobe, cap).numpy()
        np.testing.assert_array_equal(sel, want)
        assert pop[sel].min() >= np.delete(pop, sel).max()
    _same(td.search_bincompact(queries, k=4, nprobe=nprobe, cap=cap),
          jd.search_bincompact(queries, k=4, nprobe=nprobe, cap=cap))


@pytest.fixture(scope="module")
def multi_tile():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2048, 8)).astype(np.float32)
    jindex, index = _indexes(x, 8, 0)
    queries = rng.standard_normal((16, 8)).astype(np.float32)
    return (x, queries,
            jdist.DistributedIvfSearcher(jindex, x, mesh=jdist.make_mesh(2), tile=128),
            dist.DistributedIvfSearcher(index, x, mesh=dist.make_mesh(2, device=CPU),
                                        tile=128))


def test_distributed_binscan_multi_tile_recall(multi_tile):
    x, queries, jd, td = multi_tile
    assert td._rows_per_dev // td._binscan_tile() >= 2
    assert td._binscan_tile() == jd._binscan_tile()
    db, ib = td.search_binscan(queries, k=5)
    _same((db, ib), jd.search_binscan(queries, k=5))
    d2 = ((queries[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    tids = np.argsort(d2, axis=1, kind="stable")[:, :5]
    assert _hits(ib, tids) / (len(queries) * 5) >= 0.9
    want = np.sqrt(((queries[:, None, :] - x[ib]) ** 2).sum(-1))
    np.testing.assert_allclose(db, want, rtol=1e-4, atol=1e-4)


def test_distributed_bincompact_matches_fused(jmesh, mesh, data, idx1, exact64):
    jindex, index = idx1
    queries = data[[10, 99, 230]]
    de, ie = exact64[1].search(queries, k=4)
    td = dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=128)
    jd = jdist.DistributedIvfSearcher(jindex, data, mesh=jmesh, tile=128)
    got = td.search_bincompact(queries, k=4, nprobe=6, cap=td._nt_local)
    _same(got, (de, ie))
    _same(got, jd.search_bincompact(queries, k=4, nprobe=6, cap=jd._nt_local))
    d1, i1 = td.search_bincompact(queries, k=4, nprobe=3)
    assert td._bincompact_cap(3, 3) == jd._bincompact_cap(3, 3)
    _same((d1, i1), jd.search_bincompact(queries, k=4, nprobe=3))
    dl, il = td.search_bincompact(queries, k=4, nprobe=3, reps=2)
    np.testing.assert_array_equal(il, i1)
    np.testing.assert_allclose(dl, d1, rtol=1e-5)
    np.testing.assert_array_equal(
        td.search_bincompact(queries, k=4, nprobe=6, cap=10**6)[1], ie)


def test_distributed_bincompact_probe_selection():
    rng = np.random.default_rng(12)
    n, d, k = 2048, 8, 4
    centers = rng.uniform(-8, 8, (8, d)).astype(np.float32)
    lab = rng.integers(0, 8, n)
    x = (centers[lab] + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
    jindex, index = _indexes(x, 8, 0)
    td = dist.DistributedIvfSearcher(index, x, mesh=dist.make_mesh(2, device=CPU), tile=128)
    jd = jdist.DistributedIvfSearcher(jindex, x, mesh=jdist.make_mesh(2), tile=128)
    qrows = rng.integers(0, n, 16)
    queries = (x[qrows] + 0.02 * rng.standard_normal((16, d))).astype(np.float32)
    _, ref = DeviceIvfSearcher(index, x, row_tile=128, device=CPU).search(
        queries, k, nprobe=2)
    db, ib = td.search_bincompact(queries, k=k, nprobe=2)
    _same((db, ib), jd.search_bincompact(queries, k=k, nprobe=2))
    assert _hits(ib, ref.numpy()) / (len(queries) * k) >= 0.9
    assert float((ib[:, 0] == qrows).mean()) >= 0.9


@pytest.fixture(scope="module")
def spilled8(jmesh, mesh, data, idx0):
    """(JAX, port) spilled searchers at spill 0.3, tile 8, and the
    unspilled port searcher."""
    jindex, index = idx0
    return (
        jdist.DistributedIvfSearcher.with_spill(jindex, data, spill=0.3, mesh=jmesh, tile=8),
        dist.DistributedIvfSearcher.with_spill(index, data, spill=0.3, mesh=mesh, tile=8),
        dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=8),
    )


def test_distributed_spilled_matches_exact_and_dedups(data, spilled8):
    jsp, sp, base = spilled8
    assert sp._spill_dups and not base._spill_dups
    queries = data[[5, 50, 111]] + 0.02
    d0, i0 = base.search_fused(queries, k=4, nprobe=6)
    got = sp.search_fused(queries, k=4, nprobe=6)
    _same(got, (d0, i0))
    _same(got, jsp.search_fused(queries, k=4, nprobe=6))
    _distinct_originals(got[1], len(data))


def test_distributed_spilled_recall_lift(jmesh, mesh, data, idx0):
    jindex, index = idx0
    rng = np.random.default_rng(3)
    q = (data[rng.integers(0, len(data), 24)]
         + 0.3 * rng.standard_normal((24, data.shape[1]))).astype(np.float32)
    d2 = np.sum(q * q, 1)[:, None] - 2.0 * q @ data.T + np.sum(data * data, 1)[None, :]
    truth = np.argsort(d2, axis=1, kind="stable")[:, :4]
    base = dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=8)
    sp = dist.DistributedIvfSearcher.with_spill(index, data, spill=0.4, mesh=mesh, tile=8)
    jsp = jdist.DistributedIvfSearcher.with_spill(jindex, data, spill=0.4, mesh=jmesh,
                                                  tile=8)
    got = sp.search_fused(q, k=4, nprobe=1)
    _same(got, jsp.search_fused(q, k=4, nprobe=1))
    assert _hits(got[1], truth) >= _hits(base.search_fused(q, k=4, nprobe=1)[1], truth)


def test_distributed_spilled_loop_and_scan(jmesh, mesh, data, idx0):
    jindex, index = idx0
    sp = dist.DistributedIvfSearcher.with_spill(index, data, spill=0.5, mesh=mesh, tile=8)
    jsp = jdist.DistributedIvfSearcher.with_spill(jindex, data, spill=0.5, mesh=jmesh,
                                                  tile=8)
    queries = data[[7, 70]] + 0.01
    d2 = (np.sum(queries * queries, 1)[:, None] - 2.0 * queries @ data.T
          + np.sum(data * data, 1)[None, :])
    truth = np.argsort(d2, axis=1, kind="stable")[:, :3]
    got = sp.search_loop(queries, k=3, nprobe=6, reps=2)
    np.testing.assert_array_equal(got[1], truth)
    _same(got, jsp.search_loop(queries, k=3, nprobe=6, reps=2))
    scan = sp.search_scan(queries, k=3)
    _same(scan, jsp.search_scan(queries, k=3))
    _distinct_originals(scan[1], len(data))


def test_distributed_xbin8_recall_exact_distances_and_jax(jmesh, mesh, data, idx0, exact64):
    """The sharded int8 scan: recall against the sharded exact searcher,
    exact distances for the ids it returns (each shard re-scores), the JAX
    package's ids, chained too."""
    jindex, index = idx0
    rng = np.random.default_rng(5)
    queries = rng.standard_normal((5, 8)).astype(np.float32)
    _, ie = exact64[1].search(queries, k=4)
    td = dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=64)
    jd = jdist.DistributedIvfSearcher(jindex, data, mesh=jmesh, tile=64)
    d8, i8 = td.search_xbin8(queries, k=4)
    _same((d8, i8), jd.search_xbin8(queries, k=4))
    assert _hits(i8, ie) / ie.size >= 0.9
    for b in range(len(queries)):
        want = np.sqrt(((data[i8[b]] - queries[b]) ** 2).sum(1))
        np.testing.assert_allclose(d8[b], want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(td.search_xbin8(queries, k=4, reps=2)[1], i8)


def test_distributed_spilled_xbin8_dedups_as_jax(data, spilled8):
    """On the spilled layout the sharded int8 scan drops duplicate ids and
    gives the JAX package's ids."""
    jsp, sp, _ = spilled8
    queries = data[[7, 70]] + 0.01
    assert sp.can_xbin(4) == jsp.can_xbin(4)
    got = sp.search_xbin8(queries, k=4)
    _same(got, jsp.search_xbin8(queries, k=4))
    _distinct_originals(got[1], len(data))


def test_distributed_bincompact_calibration(jmesh, mesh, data, idx0):
    jindex, index = idx0
    td = dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=128)
    jd = jdist.DistributedIvfSearcher(jindex, data, mesh=jmesh, tile=128)
    queries = data[[5, 50, 111]] + 0.02
    d0, i0 = td.search_bincompact(queries, k=4, nprobe=3)
    cap = td.calibrate_bincompact(queries, nprobe=3, k=4)
    assert cap == jd.calibrate_bincompact(queries, nprobe=3, k=4)
    assert 1 <= cap <= td._nt_local
    got = td.search_bincompact(queries, k=4, nprobe=3)
    _same(got, (d0, i0))
    _same(got, jd.search_bincompact(queries, k=4, nprobe=3))
    td.calibrate_bincompact(queries, nprobe=6, k=4)
    _, ic = td.search_bincompact(queries, k=4, nprobe=6)
    _, ie = td.search_fused(queries, k=4, nprobe=6)
    np.testing.assert_array_equal(ic, ie)
    td._bincompact_calibrated = None
    jd._bincompact_calibrated = None


def test_cluster_axis_spilled(data, idx0, ivf8):
    jindex, index = idx0
    m2 = dist.make_mesh_2d(4, 2, device=CPU)
    base = dist.DistributedClusterIvfSearcher(index, data, mesh=m2, tile=8)
    sp = dist.DistributedClusterIvfSearcher.with_spill(index, data, spill=0.3, mesh=m2,
                                                       tile=8)
    jsp = jdist.DistributedClusterIvfSearcher.with_spill(
        jindex, data, spill=0.3, mesh=jdist.make_mesh_2d(4, 2), tile=8)
    queries = data[[5, 50, 111]] + 0.02
    d0, i0 = base.search(queries, k=4, nprobe=6)
    ref = dist.DistributedIvfSearcher(index, data, mesh=dist.make_mesh(8, device=CPU),
                                      tile=8)
    _same((d0, i0), ref.search_fused(queries, k=4, nprobe=6), rtol=1e-4, atol=1e-4)
    got = sp.search(queries, k=4, nprobe=6)
    _same(got, (d0, i0))
    _same(got, jsp.search(queries, k=4, nprobe=6))
    np.testing.assert_array_equal(sp.search_loop(queries, k=4, nprobe=6, reps=2)[1], i0)
    _distinct_originals(got[1], len(data))


def test_distributed_binscan8_recall_and_exact_distances():
    rng = np.random.default_rng(31)
    n, d, k = 2048, 8, 5
    x = rng.standard_normal((n, d)).astype(np.float32)
    jindex, index = _indexes(x, 8, 0)
    td = dist.DistributedIvfSearcher(index, x, mesh=dist.make_mesh(2, device=CPU), tile=128)
    jd = jdist.DistributedIvfSearcher(jindex, x, mesh=jdist.make_mesh(2), tile=128)
    assert td.can_binscan(k, esize=1)
    queries = rng.standard_normal((16, d)).astype(np.float32)
    db, ib = td.search_binscan8(queries, k=k)
    _same((db, ib), jd.search_binscan8(queries, k=k))
    d2 = ((queries[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    tids = np.argsort(d2, axis=1, kind="stable")[:, :k]
    assert _hits(ib, tids) / (len(queries) * k) >= 0.85
    want = np.sqrt(((queries[:, None, :] - x[ib]) ** 2).sum(-1))
    np.testing.assert_allclose(db, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(td.search_binscan8(queries, k=k, reps=2)[1], ib)


@pytest.fixture(scope="module")
def near_tie_dist():
    """Groups of 4 rows 1e-4 apart (below bf16's resolution): their order
    is recoverable only through the f32 rows."""
    rng = np.random.default_rng(7)
    n_groups, per, d = 48, 4, 16
    centers = rng.uniform(-4, 4, (n_groups, d)).astype(np.float32)
    rows = [centers[g] + (1e-4 * j) * np.eye(d, dtype=np.float32)[0]
            for g in range(n_groups) for j in range(per)]
    x = np.stack(rows).astype(np.float32)
    jindex, index = _indexes(x, 6, 0)
    gq = rng.integers(0, n_groups, 16)
    q = centers[gq].copy()
    q[:, 0] += 2.1e-4
    return x, jindex, index, q


def test_distributed_rescore_recovers_f32_ranking(jmesh, mesh, near_tie_dist):
    x, jindex, index, q = near_tie_dist
    s = dist.DistributedIvfSearcher(index, x, mesh=mesh, tile=8, dtype=torch.bfloat16)
    js = jdist.DistributedIvfSearcher(jindex, x, mesh=jmesh, tile=8,
                                      dtype=jax.numpy.bfloat16)
    assert s._emb_ref is not None and s.emb[0].dtype == torch.bfloat16
    d2 = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    top1 = np.argsort(d2, axis=1, kind="stable")[:, 0]
    for name in ("search", "search_fused", "search_scan"):
        args = (q, 4) if name == "search_scan" else (q, 4, 6)
        d, ids = getattr(s, name)(*args)
        assert (ids[:, 0] == top1).mean() >= 0.9, name
        want = np.sqrt(((q[:, None, :] - x[ids]) ** 2).sum(-1))
        np.testing.assert_allclose(d, want, rtol=1e-4, atol=1e-5)
        jd_, jids = getattr(js, name)(*args)
        for a, b in zip(ids, np.asarray(jids)):
            assert len(set(a.tolist()) & set(b.tolist())) >= 0.8 * len(a), name
    s_no = dist.DistributedIvfSearcher(index, x, mesh=mesh, tile=8, dtype=torch.bfloat16,
                                       rescore_dtype=None)
    assert s_no._emb_ref is None


def test_distributed_spilled_rescore(jmesh, mesh, near_tie_dist):
    x, jindex, index, q = near_tie_dist
    sp = dist.DistributedIvfSearcher.with_spill(index, x, spill=0.3, mesh=mesh, tile=8,
                                                dtype=torch.bfloat16)
    assert sp._spill_dups and sp._emb_ref is not None
    base = dist.DistributedIvfSearcher(index, x, mesh=mesh, tile=8)
    d0, i0 = base.search_fused(q, k=4, nprobe=6)
    got = sp.search_fused(q, k=4, nprobe=6)
    np.testing.assert_array_equal(got[1], i0)
    np.testing.assert_allclose(got[0], d0, rtol=1e-4, atol=1e-5)
    jsp = jdist.DistributedIvfSearcher.with_spill(jindex, x, spill=0.3, mesh=jmesh, tile=8,
                                                  dtype=jax.numpy.bfloat16)
    _same(got, jsp.search_fused(q, k=4, nprobe=6), rtol=1e-4, atol=1e-5)


def test_spilled_bf16_fetch_beyond_a_kernel_list_raises(mesh, near_tie_dist):
    """A spilled searcher with an f32 copy fetches 4k a shard; past a
    kernel's 128 slots K3 raises rather than clip."""
    x, _, index, q = near_tie_dist
    sp = dist.DistributedIvfSearcher.with_spill(index, x, spill=0.3, mesh=mesh, tile=8,
                                                dtype=torch.bfloat16)
    sp.search_fused(q, k=32, nprobe=6)  # 128 a shard: fits
    with pytest.raises(ValueError, match="k <= 128"):
        sp.search_fused(q, k=33, nprobe=6)


def test_distributed_dynamic_updates(jmesh, mesh, data, idx0):
    jindex, index = idx0
    s = dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=8)
    js = jdist.DistributedIvfSearcher(jindex, data, mesh=jmesh, tile=8)
    queries = data[[5, 50, 111]] + 0.02
    _, i0 = s.search(queries, k=3, nprobe=6)
    victims = np.unique(i0[:, 0])
    for t in (s, js):
        t.delete_rows(victims)
    appended = s.append_rows(queries + 0.001)
    np.testing.assert_array_equal(appended, js.append_rows(queries + 0.001))
    for name, args in (("search", (3, 6)), ("search_fused", (3, 6)),
                       ("search_scan", (3,)), ("search_loop", (3, 6, 2))):
        d, ids = getattr(s, name)(queries, *args)
        _same((d, ids), getattr(js, name)(queries, *args))
        assert not np.isin(ids, victims).any(), name
        assert (ids[:, 0] == appended).all(), name
        assert np.isfinite(d[:, 0]).all(), name
    s.delete_rows(appended[:1])
    _, ids = s.search(queries[:1], k=3, nprobe=6)
    assert appended[0] not in ids
    with pytest.raises(ValidationError, match="delete_rows"):
        s.delete_rows([10**6])
    with pytest.raises(ValidationError, match="append_rows"):
        s.append_rows(np.zeros((2, 3), np.float32))


def test_distributed_dynamic_spilled(jmesh, mesh, data, idx0):
    """Deletes tombstone every copy of a spilled row (copies may sit on two
    shards)."""
    jindex, index = idx0
    sp = dist.DistributedIvfSearcher.with_spill(index, data, spill=0.5, mesh=mesh, tile=8)
    jsp = jdist.DistributedIvfSearcher.with_spill(jindex, data, spill=0.5, mesh=jmesh,
                                                  tile=8)
    queries = data[[5, 50, 111]] + 0.02
    _, i0 = sp.search_fused(queries, k=3, nprobe=6)
    victims = np.unique(i0[:, 0])
    for t in (sp, jsp):
        t.delete_rows(victims)
    got = sp.search_fused(queries, k=3, nprobe=6)
    _same(got, jsp.search_fused(queries, k=3, nprobe=6))
    assert not np.isin(got[1], victims).any()
    for r in got[1]:
        live = [v for v in r.tolist() if v >= 0]
        assert len(set(live)) == len(live)


# ----------------------------------------------------------------------
# The port's own checks
# ----------------------------------------------------------------------


def test_layout_equals_the_jax_searchers_by_shard(jmesh, mesh, data, idx0, near_tie_dist):
    """The same index and rows build both packages' searchers: every
    per-shard array equals the JAX searcher's, split by shard
    (``convert.dist_searcher_state_from_reference``), pads and sentinels
    included; the 2-D searcher's too."""
    cases = []
    x, jindex, index, _ = near_tie_dist
    cases.append((jdist.DistributedIvfSearcher(jindex, x, mesh=jmesh, tile=8,
                                               dtype=jax.numpy.bfloat16),
                  dist.DistributedIvfSearcher(index, x, mesh=mesh, tile=8,
                                              dtype=torch.bfloat16)))
    jindex, index = idx0
    cases.append((jdist.DistributedIvfSearcher.with_spill(jindex, data, spill=0.3,
                                                          mesh=jmesh, tile=8),
                   dist.DistributedIvfSearcher.with_spill(index, data, spill=0.3,
                                                          mesh=mesh, tile=8)))
    cases.append((jdist.DistributedClusterIvfSearcher(
        jindex, data, mesh=jdist.make_mesh_2d(4, 2), tile=8),
        dist.DistributedClusterIvfSearcher(
            index, data, mesh=dist.make_mesh_2d(4, 2, device=CPU), tile=8)))
    for want_s, got_s in cases:
        state = dist_searcher_state_from_reference(want_s, device=CPU)
        held = 0
        for name, parts in state.items():
            mine = getattr(got_s, name, None)
            assert (parts is None) == (mine is None), name
            if parts is None:
                continue
            assert len(parts) == len(mine) == got_s.mesh.size, name
            for a, b in zip(parts, mine):
                assert a.dtype == b.dtype and a.shape == b.shape, name
                assert torch.equal(a, b), name
            held += 1
        assert held >= 5
        # the JAX tile tables pad to 128 lanes with the sentinel cluster
        jtc = np.asarray(want_s.tc)
        assert (jtc[:, got_s._cmax:] == want_s.index.n_clusters).all()


@pytest.mark.parametrize("kind", ["rows", "spilled rows", "2-D"])
def test_each_shards_offsets_are_its_rows(mesh, data, idx0, kind):
    """K3 reads each shard's ``offsets``, made once at set-up: the first
    row of each cluster in the shard's block, each row's cluster as its tile
    tables give it, then the first pad row."""
    _, index = idx0
    if kind == "2-D":
        s = dist.DistributedClusterIvfSearcher(
            index, data, mesh=dist.make_mesh_2d(4, 2, device=CPU), tile=8)
    elif kind == "spilled rows":
        s = dist.DistributedIvfSearcher.with_spill(index, data, spill=0.3, mesh=mesh, tile=8)
    else:
        s = dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=8)
    kc = s.index.n_clusters
    assert len(s.offsets) == s.mesh.size
    for tc, lcl, offsets in zip(s.tc, s.lcl, s.offsets):
        rows = tc.gather(1, lcl.view(tc.shape[0], -1).long()).reshape(-1).numpy()
        assert (np.diff(rows) >= 0).all() and rows[-1] == kc  # sorted, a pad row last
        assert offsets.dtype == torch.int32
        np.testing.assert_array_equal(offsets.numpy(), np.searchsorted(rows, np.arange(kc + 1)))


def test_mesh_size_invariance(data, idx1):
    """2 and 8 shards: the Lloyd loop's bits (those of the single-device
    ``_lloyd``), the same exact, gather, fused and probed-union results."""
    _, index = idx1
    rng = np.random.default_rng(0)
    c0 = data[rng.choice(len(data), 6, replace=False)].copy()
    queries = data[[3, 99, 180]] + 0.01
    out = []
    for n in (2, 8):
        m = dist.make_mesh(n, device=CPU)
        s = dist.DistributedIvfSearcher(index, data, mesh=m, tile=128)
        out.append((
            dist.distributed_lloyd(data, c0, 10, mesh=m, block_rows=16),
            dist.DistributedExactSearcher(data, mesh=m, row_tile=8).search(queries, 5),
            s.search(queries, 4, 3), s.search_fused(queries, 4, 3),
            s.search_bincompact(queries, 4, 6, cap=s._nt_local),
        ))
    (c2, a2), *res2 = out[0]
    (c8, a8), *res8 = out[1]
    # the block sums add in row order whatever the shards: the bits of the
    # single-device loop over the same blocks
    c1, a1 = tkm._lloyd(torch.from_numpy(data), torch.from_numpy(c0), 10, 16, 6)
    for c, a in ((c2, a2), (c8, a8)):
        assert c.tobytes() == c1.numpy().tobytes()
        np.testing.assert_array_equal(a, a1.numpy())
    for got, want in zip(res2, res8):
        _same(got, want)


def test_fused_against_the_single_device_stream_search(mesh, data, idx1):
    """The port's single-device K3 (``search(mode="stream")`` on the
    cluster-sorted layout) returns the sharded K3's ids on f32 rows. On
    bf16 rows with the f32 copy each shard fetches 2k at storage precision,
    a superset of the single searcher's k, so every slot of the sharded
    result is at least as near (on this tight-cluster data bf16 cannot
    rank neighbours at all, and the two differ)."""
    _, index = idx1
    queries = data[[10, 99, 230, 7]] + 0.01
    for dtype in (torch.float32, torch.bfloat16):
        single = DeviceIvfSearcher(index, data, dtype=dtype, row_tile=8,
                                   cluster_sorted=True, device=CPU)
        sharded = dist.DistributedIvfSearcher(index, data, mesh=mesh, tile=8,
                                              dtype=dtype)
        for nprobe in (1, 3, 6):
            d_s, i_s = single.search(queries, 4, nprobe, mode="stream")
            got = sharded.search_fused(queries, 4, nprobe)
            if dtype == torch.float32:
                _same(got, (d_s.numpy(), i_s.numpy()))
            else:
                assert (got[0] <= d_s.numpy() + 1e-6).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return "cuda:0"


@pytest.mark.cuda
def test_sharded_kernels_on_the_card_equal_the_cpu_mesh(cuda_device):
    """Four shards of one card (K1, K3, K7, K8, K2 on each): the sharded
    build has one shard's index bytes; the fused, full-cap probed-union,
    binned and exact searches give the ids of four CPU shards (the plain
    versions) on the same index, but at ties."""
    rng = np.random.default_rng(5)
    centers = 4.0 * rng.standard_normal((32, 64)).astype(np.float32)
    x = (centers[rng.integers(0, 32, 20000)]
         + rng.standard_normal((20000, 64)).astype(np.float32)).astype(np.float32)
    q = (x[rng.integers(0, 20000, 64)] + 0.1).astype(np.float32)
    cfg = IvfBuildConfig(n_clusters=32, block_rows=2048)
    builds = [dist.build_ivf_index_distributed(
        Embeddings(x, 64), cfg, mesh=dist.make_mesh(n, device=cuda_device)) for n in (4, 1)]
    assert builds[0].to_bytes() == builds[1].to_bytes()
    index = builds[0]
    out = []
    for device in (cuda_device, CPU):
        m = dist.make_mesh(4, device=device)
        s = dist.DistributedIvfSearcher(index, x, mesh=m, tile=512)
        out.append((s.search_fused(q, 10, 4), s.search_binscan(q, 10),
                    s.search_bincompact(q, 10, 32, cap=s._nt_local),
                    dist.DistributedExactSearcher(x, mesh=m).search(q, 10)))
    for got, want in zip(*out):
        # slot by slot the same distance: ids may differ only at a tie
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
        assert (got[1] == want[1]).mean() >= 0.99
