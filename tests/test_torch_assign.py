"""K1 (nearest-centroid assignment) in the torch port against the JAX package.

The same seeded numpy inputs go through ``assign_clusters_pallas`` (Pallas
in interpret mode on the CPU) and through the port's ``assign_rows``, which
runs its plain torch version on CPU tensors. Assignments must be equal: the
data keeps every row's two nearest centroids apart by far more than f32
rounding, so equal ids are the right test, not a tolerance. Ties go to the
lower centroid index in both.

K1 runs on the score tile of ``csrc/score_tile.cuh`` with the rows of ``x``
on the tile's query side (128 a block) and the centroids walked in chunks of
128. The shapes that makes awkward (d = 3 and 100, 3 to 4096 centroids, row
counts around a block, every centroid repeated so that ties cross chunks and
lanes) go through the JAX kernel and the wrapper on the CPU here, and
through the kernel on the card against the plain version: ids equal on grid
data, and on continuous data equal wherever the two best scores differ by
more than 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from pqvector_tpu.kernels.assign import assign_clusters_pallas
from pqvector_tpu_torch.kernels import _build
from pqvector_tpu_torch.kernels.assign import (
    assign_clusters,
    assign_rows,
    assign_rows_plain,
)


def _blobs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((k, d)).astype(np.float32) * 4.0
    x = c[rng.integers(0, k, n)] + 0.1 * rng.standard_normal((n, d)).astype(np.float32)
    return x, c


@pytest.mark.parametrize("n,d,k", [(256, 16, 8), (1000, 32, 37), (300, 64, 64), (5, 8, 3)])
def test_plain_matches_pallas(n, d, k):
    x, c = _blobs(n, d, k, seed=n + k)
    want = assign_clusters_pallas(x, c, tile=128, interpret=True)
    got = assign_clusters(x, c, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_ties_go_to_lowest_centroid():
    """Duplicated centroids: every row ties between copies; both packages
    pick the lowest index (jnp.argmin's first minimum)."""
    rng = np.random.default_rng(3)
    base = rng.integers(-3, 4, (6, 8)).astype(np.float32)
    c = np.concatenate([base, base, base])  # ids j, j + 6, j + 12 tie
    # Small integers: every score is exact in f32, so the ties are exact.
    x = base[rng.integers(0, 6, 200)] + rng.integers(-1, 2, (200, 8)).astype(np.float32)
    want = assign_clusters_pallas(x, c, tile=128, interpret=True)
    got = assign_clusters(x, c, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.max() < 6


def _grid_blobs(n, d, k, seed):
    """Centroids on a 1/4 grid, each repeated up to three times, and rows
    near them: every score is exact in f32 and every row ties between the
    copies of its centroid."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-8, 9, (-(-k // 3), d)).astype(np.float32) / 4
    c = np.concatenate([base, base, base])[:k]
    x = base[rng.integers(0, base.shape[0], n)] + rng.integers(-2, 3, (n, d)).astype(np.float32) / 4
    return x, c, base.shape[0]


AWKWARD = [  # n, d, centroids
    (5, 3, 3), (300, 100, 37), (129, 8, 1), (257, 16, 4096), (64, 72, 130),
    (383, 128, 128), (1, 5, 2), (1001, 40, 69),
]


@pytest.mark.parametrize("n,d,k", AWKWARD)
def test_plain_matches_pallas_at_awkward_shapes(n, d, k):
    x, c, distinct = _grid_blobs(n, d, k, seed=n + d + k)
    want = assign_clusters_pallas(x, c, tile=128, interpret=True)
    got = assign_clusters(x, c, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.shape == (n,) and got.max() < distinct  # the lowest copy wins


@pytest.mark.parametrize("n,d,k", [(700, 3, 37), (515, 100, 69), (130, 24, 4096)])
def test_plain_matches_pallas_on_continuous_data(n, d, k):
    """No planted gap between the two nearest centroids: ids are equal
    wherever the best and the second-best score differ by more than 1e-5
    relative (float64 scores decide which rows those are)."""
    rng = np.random.default_rng(n + k)
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    want = assign_clusters_pallas(x, c, tile=128, interpret=True)
    got = assign_clusters(x, c, device="cpu")
    s = (c.astype(np.float64) ** 2).sum(1)[None, :] - 2.0 * x.astype(np.float64) @ c.T
    two = np.sort(s, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > 1e-5 * (np.abs(two[:, 0]) + (x.astype(np.float64) ** 2).sum(1))
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(got[clear], want[clear])
    np.testing.assert_array_equal(got[clear], s.argmin(1)[clear])


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    x, c = _blobs(500, 16, 10, seed=9)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    before = dict(_build.LAUNCHES)
    np.testing.assert_array_equal(assign_rows(xt, ct), assign_rows_plain(xt, ct))
    assert _build.LAUNCHES == before


@pytest.mark.parametrize(
    "x,c,err",
    [
        (torch.zeros(4, 8, dtype=torch.float64), torch.zeros(2, 8), TypeError),
        (torch.zeros(4, 8), torch.zeros(2, 7), ValueError),
    ],
)
def test_wrapper_rejects_bad_operands(x, c, err):
    with pytest.raises(err):
        assign_rows(x, c)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    x, c = _blobs(100_003, 128, 1024, seed=1)
    xt = torch.from_numpy(x).to(cuda_device)
    ct = torch.from_numpy(c).to(cuda_device)
    got = assign_rows(xt, ct)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu(), assign_rows_plain(xt, ct).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", AWKWARD)
def test_kernel_equals_plain_on_card_at_awkward_shapes(cuda_device, n, d, k):
    """Grid data: every score exact, so ids are equal and ties go to the
    lowest centroid index across chunks and lanes."""
    x, c, distinct = _grid_blobs(n, d, k, seed=n + d + k)
    xt = torch.from_numpy(x).to(cuda_device)
    ct = torch.from_numpy(c).to(cuda_device)
    before = _build.LAUNCHES["K1"]
    got = assign_rows(xt, ct)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["K1"] == before + 1
    assert torch.equal(got, assign_rows_plain(xt, ct))
    assert int(got.max()) < distinct
