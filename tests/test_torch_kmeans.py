"""k-means and the IVF build in the torch port against the JAX package.

Lloyd's loop is compared from one injected initialisation: assignments must
be equal and centroids agree at rtol 1e-5 (f32 sums taken in another order).
The port's k-means++ draws the scalars ``jax.random`` gives the JAX package
for the same seed (a host-side threefry2x32, held to ``jax.random`` bit for
bit here), so on the fixtures of ``tests/test_kmeans.py`` and
``tests/test_determinism.py`` both pick the same seed rows and end in the
same partition with the same labels. On well-separated blobs the two full
builds find the same partition up to a relabelling of clusters.
"""

import jax
import numpy as np
import pytest
import torch

from pqvector_tpu.index import build as jbuild
from pqvector_tpu.index import kmeans as jkm
from pqvector_tpu.types import Embeddings as JEmbeddings
from pqvector_tpu_torch.errors import ValidationError
from pqvector_tpu_torch.index import build as tbuild
from pqvector_tpu_torch.index import _threefry as tf
from pqvector_tpu_torch.index import kmeans as tkm
from pqvector_tpu_torch.types import Embeddings


def _blobs(n, d, k, seed, spread=0.05):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-1.0, 1.0, (k, d)).astype(np.float32)
    x = c[rng.integers(0, k, n)] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return x


def _jax_lloyd(x, init, max_iters, block):
    xp, w = jkm._pad_rows(x, block)
    c, a = jkm._lloyd(xp, w, init, max_iters, block, init.shape[0])
    return np.asarray(c), np.asarray(a)[: x.shape[0]]


@pytest.mark.parametrize("n,d,k,iters", [(2000, 16, 12, 20), (1500, 32, 20, 3), (777, 8, 5, 20)])
def test_lloyd_matches_jax_from_injected_init(n, d, k, iters):
    x = _blobs(n, d, k, seed=n, spread=0.15)
    rng = np.random.default_rng(k)
    init = x[rng.choice(n, k, replace=False)]
    want_c, want_a = _jax_lloyd(x, init, iters, 256)
    got_c, got_a = tkm._lloyd(torch.from_numpy(x), torch.from_numpy(init), iters, 256, k)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-5, atol=1e-6)


def test_lloyd_keeps_stale_centroid_for_empty_cluster():
    x = _blobs(600, 8, 4, seed=2)
    init = np.concatenate([x[:4], np.full((1, 8), 50.0, np.float32)])
    want_c, want_a = _jax_lloyd(x, init, 20, 256)
    got_c, got_a = tkm._lloyd(torch.from_numpy(x), torch.from_numpy(init), 20, 256, 5)
    np.testing.assert_array_equal(got_a.numpy(), want_a)
    np.testing.assert_allclose(got_c.numpy(), want_c, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got_c.numpy()[4], init[4])


def test_host_sampling_and_sizes_match_jax():
    np.testing.assert_array_equal(
        tkm.sample_indices_host(7, 10_000, 500), jkm.sample_indices_host(7, 10_000, 500)
    )
    for n, k in [(10, 3), (1_000_000, 1024), (50_000, 300)]:
        assert tkm.default_n_clusters(n) == jkm.default_n_clusters(n)
        assert tkm.train_sample_size(n, k) == jkm.train_sample_size(n, k)


def test_kmeans_pp_init_is_seeded_and_picks_sample_rows():
    x = torch.from_numpy(_blobs(500, 8, 6, seed=4))
    a = tkm._kmeans_pp_init(x, tkm.init_key(42), 6)
    b = tkm._kmeans_pp_init(x, tkm.init_key(42), 6)
    assert torch.equal(a, b)
    # every seed is a row of the sample
    assert all(bool((x == row).all(dim=1).any()) for row in a)


@pytest.mark.parametrize("seed", [0, 1, 42, 123456789, 2**31 + 3])
def test_threefry_primitives_equal_jax_random(seed):
    """PRNGKey, split, uniform and randint of shape () against the installed
    jax (threefry2x32, jax_threefry_partitionable on): equal bits, also for a
    span that is no power of two and for spans above 2**16."""
    assert jax.config.jax_threefry_partitionable
    jkey = jax.random.PRNGKey(seed)
    key = tf.prng_key(seed)
    assert tuple(int(w) for w in np.asarray(jkey)) == key
    for num in (2, 3):
        want = [tuple(int(w) for w in row) for row in np.asarray(jax.random.split(jkey, num))]
        assert tf.split(key, num) == want
    want_u = np.float32(jax.random.uniform(jkey, (), np.float32))
    assert np.float32(tf.uniform(key)).tobytes() == want_u.tobytes()
    for m in (1, 2, 1000, 1024, 49_999, 50_000, 65_536, 65_537, 100_003, 2**31 - 1):
        assert int(tf.randint(key, m)) == int(jax.random.randint(jkey, (), 0, m)), m


def _jax_kmeans_pp_scalars(seed, m, k, n_split=3):
    """The reference's key chain (pqvector_tpu/index/kmeans.py: k_means and
    _kmeans_pp_init), drawn with jax.random. ``n_split=2`` is the
    distributed build's init key (pqvector_tpu/dist/build.py)."""
    key = jax.random.PRNGKey(seed)
    init_key = jax.random.split(key, n_split)[1]
    key, sub = jax.random.split(init_key)
    first = int(jax.random.randint(sub, (), 0, m))
    u = np.zeros(k, np.float32)
    uniform_idx = np.zeros(k, np.int64)
    for i in range(1, k):
        key, t_key, u_key = jax.random.split(key, 3)
        u[i] = jax.random.uniform(t_key, (), np.float32)
        uniform_idx[i] = jax.random.randint(u_key, (), 0, m)
    return first, u, uniform_idx


@pytest.mark.parametrize(
    "seed,m,k", [(42, 50_000, 24), (1, 777, 5), (7, 3000, 32), (9, 1000, 1), (3, 70_001, 6)]
)
def test_kmeans_pp_scalars_equal_jax_random(seed, m, k):
    """``first``, every ``u[i]`` and every ``uniform_idx[i]`` equal
    jax.random's bit for bit, for sample sizes that are no power of two."""
    want = _jax_kmeans_pp_scalars(seed, m, k)
    got = tf.kmeans_pp_scalars(seed, m, k)
    assert got[0] == want[0]
    assert got[1].dtype == np.float32 and got[1].tobytes() == want[1].tobytes()
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("seed,m,k", [(42, 50_000, 24), (5, 12, 6), (3, 70_001, 6)])
def test_kmeans_pp_scalars_from_the_two_way_key_equal_jax_random(seed, m, k):
    """The key-level entry on the distributed build's init key,
    ``split(PRNGKey(seed))[1]``: equal bits to jax.random's draws. The seed
    form takes the single build's three-way key, whose second key is the
    same block of threefry (counter (0, 1)), so both draw the same."""
    want = _jax_kmeans_pp_scalars(seed, m, k, n_split=2)
    got = tf.kmeans_pp_scalars_from_key(tf.split(tf.prng_key(seed))[1], m, k)
    assert got[0] == want[0]
    assert got[1].tobytes() == want[1].tobytes()
    np.testing.assert_array_equal(got[2], want[2])
    single = tf.kmeans_pp_scalars(seed, m, k)
    three = tf.kmeans_pp_scalars_from_key(tf.split(tf.prng_key(seed), 3)[1], m, k)
    assert single[0] == three[0] and single[1].tobytes() == three[1].tobytes()
    assert tf.split(tf.prng_key(seed))[1] == tf.split(tf.prng_key(seed), 3)[1]
    assert got[0] == single[0] and got[1].tobytes() == single[1].tobytes()


def test_kmeans_pp_init_takes_a_key():
    """``_kmeans_pp_init`` with the two-way key picks the JAX package's seed
    rows for that key (the distributed build's seeding)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    want = np.asarray(jkm._kmeans_pp_init(x, jax.random.split(jax.random.PRNGKey(9))[1], 7))
    got = tkm._kmeans_pp_init(torch.from_numpy(x), tf.split(tf.prng_key(9))[1], 7)
    np.testing.assert_array_equal(got.numpy(), want)


def _fixture_blobs(n_per, centers, seed):
    """``make_blobs`` of tests/test_kmeans.py."""
    rng = np.random.default_rng(seed)
    centers = np.asarray(centers, np.float32)
    return np.concatenate([
        c + 0.05 * rng.standard_normal((n_per, centers.shape[1])).astype(np.float32)
        for c in centers
    ])


_JAX_FIXTURES = {
    # tests/test_kmeans.py
    "clear_blobs": lambda: (_fixture_blobs(50, [[0, 0], [10, 0], [0, 10], [10, 10]], 0), 4, 1),
    "three_blobs": lambda: (_fixture_blobs(30, [[0, 0], [5, 5], [0, 5]], 3), 3, 42),
    # tests/test_determinism.py
    "normal_seed7": lambda: (
        np.random.default_rng(0).standard_normal((3000, 16)).astype(np.float32), 32, 7),
    "normal_seed8": lambda: (
        np.random.default_rng(0).standard_normal((3000, 16)).astype(np.float32), 32, 8),
    "file_seed123": lambda: (
        np.random.default_rng(1).standard_normal((500, 8)).astype(np.float32), 8, 123),
}


@pytest.mark.parametrize("name", sorted(_JAX_FIXTURES))
def test_seed_rows_and_partition_equal_jax_on_its_fixtures(name):
    """Same seed rows from k-means++, and after Lloyd the same assignment
    with the same labels (centroids at rtol 1e-5: f32 sums in another
    order). ``jnp.cumsum`` and ``_prefix_sums`` could round a boundary
    differently and so pick another row; on these five fixtures they do
    not, so the comparison is exact and none is excused."""
    x, k, seed = _JAX_FIXTURES[name]()
    _, init_key, _ = jax.random.split(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jkm._kmeans_pp_init(jax.numpy.asarray(x), init_key, k))
    got = tkm._kmeans_pp_init(torch.from_numpy(x), tkm.init_key(seed), k).numpy()
    np.testing.assert_array_equal(got, want)
    want_c, want_a = jkm.k_means(x, jkm.KMeansParams(n_clusters=k, seed=seed))
    got_c, got_a = tkm.k_means(x, tkm.KMeansParams(n_clusters=k, seed=seed), device="cpu")
    np.testing.assert_array_equal(got_a, want_a)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("m", [1, 1000, 1024, 1025, 50_000])
def test_prefix_sums_match_float64_cumsum(m):
    v = torch.from_numpy(np.random.default_rng(m).uniform(0.0, 4.0, m).astype(np.float32))
    got = tkm._prefix_sums(v)
    want = np.cumsum(v.numpy().astype(np.float64))
    assert got.shape == (m,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


@pytest.mark.cuda
def test_prefix_sums_are_bitwise_stable_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    v = torch.rand(50_000, generator=torch.Generator().manual_seed(0)).cuda()
    first = tkm._prefix_sums(v)
    for _ in range(50):
        assert torch.equal(tkm._prefix_sums(v), first)


def _same_partition(a, b):
    """True when assignments a and b differ only by a relabelling."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("n,k", [(3000, 8), (40_000, 16)])
def test_build_partition_matches_jax_up_to_relabelling(n, k):
    """n=40k trains on the 5% sample both packages draw alike."""
    x = _blobs(n, 16, k, seed=k, spread=0.02)
    want = jbuild.build_ivf_index(JEmbeddings(x, 16), jbuild.IvfBuildConfig(n_clusters=k))
    got = tbuild.build_ivf_index(Embeddings(x, 16), tbuild.IvfBuildConfig(n_clusters=k),
                                 device="cpu")

    def assign(idx):
        out = np.empty(idx.total_rows, np.int64)
        for c in range(idx.n_clusters):
            out[idx.cluster_rows(c)] = c
        return out

    assert _same_partition(assign(got), assign(want))


def test_build_is_deterministic_per_seed():
    x = _blobs(5000, 16, 10, seed=5, spread=0.2)
    cfg = tbuild.IvfBuildConfig(n_clusters=10, seed=3)
    a = tbuild.build_ivf_index(Embeddings(x, 16), cfg, device="cpu").to_bytes()
    b = tbuild.build_ivf_index(Embeddings(x, 16), cfg, device="cpu").to_bytes()
    assert a == b


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_tunnel_wires_are_not_ported(wire):
    """The bf16 and int8 wires are ported. On the full-sample branch (n =
    100) the in-memory build gives the JAX package's index bytes; on a 5%
    sample (n = 40,000) its row lists, with centroids at rtol 1e-5 as
    Lloyd's f32 sums are taken in another order (the f32 wire differs from
    the JAX package's there the same way). Either way the wire build is
    the port's f32 build of the rows the wire rounded, byte for byte."""
    for n, k in ((100, 2), (40_000, 16)):
        x = _blobs(n, 4, k, seed=1)
        got = tbuild.build_ivf_index(
            Embeddings(x, 4), tbuild.IvfBuildConfig(n_clusters=k, transfer_dtype=wire),
            device="cpu",
        )
        want = jbuild.build_ivf_index(
            JEmbeddings(x, 4), jbuild.IvfBuildConfig(n_clusters=k, transfer_dtype=wire))
        np.testing.assert_array_equal(got.row_ids, want.row_ids)
        np.testing.assert_array_equal(got.list_offsets, want.list_offsets)
        np.testing.assert_allclose(got.centroids, want.centroids, rtol=1e-5, atol=1e-6)
        if n == 100:
            assert got.to_bytes() == want.to_bytes()
        if wire == "bfloat16":
            rounded = tbuild._bf16_tensor(tbuild._cast_bf16(x)).float().numpy()
        else:
            codes, scales = tbuild._encode_int8(x)
            rounded = tbuild._dequant_i8(torch.from_numpy(codes),
                                         torch.from_numpy(scales)).numpy()
        f32 = tbuild.build_ivf_index(Embeddings(rounded, 4),
                                     tbuild.IvfBuildConfig(n_clusters=k), device="cpu")
        assert got.to_bytes() == f32.to_bytes()


@pytest.mark.parametrize("kw", [{"max_iters": 0}, {"n_clusters": 0}, {"transfer_dtype": "f16"}])
def test_build_config_validation_matches_jax(kw):
    with pytest.raises(ValidationError):
        tbuild.IvfBuildConfig(**kw)
    with pytest.raises(Exception):
        jbuild.IvfBuildConfig(**kw)
