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

K1 on bf16 rows has two forms on the card, the FMA form and the screen
(``bf16_route``): the centroids split into three bf16 pieces
(``split_bf16x3``), tensor-core scores, and a certificate
(``screen_coefficients``, derived in ``csrc/assign.cu``) that keeps a row's
id only where the f32 form must give the same one. Here: the split is exact,
both halves of the bound hold against float64 on seeded and
cancellation-heavy data, the plain screen (``assign_rows_screened_plain``)
gives the plain version's ids and the JAX kernel's off near ties, and planted
ties are never certified. On the card both forms give K1 f32's ids over the
widened rows at awkward shapes.

K1 on f32 rows has the same two routes (``f32_route``): ``pqv_assign`` over
every row, or the f32-row screen, which splits each row into bf16 pieces
(``split_f32_rows``), sums three piece products on the tensor cores and
certifies a row's id against ``pqv_assign``'s own rounding and the products it
leaves out (``screen_coefficients_f32``), then ``pqv_assign`` over the rows it
leaves. The same holds are made for it here, and on the card its ids are
``pqv_assign``'s.
"""

import math

import numpy as np
import pytest
import torch

from pqvector_tpu.kernels.assign import assign_clusters_pallas
from pqvector_tpu_torch.kernels import _build
from pqvector_tpu_torch.kernels import assign as ka
from pqvector_tpu_torch.kernels import score_tile
from pqvector_tpu_torch.kernels.assign import (
    assign_clusters,
    assign_rows,
    assign_rows_plain,
    assign_rows_screened_plain,
    bf16_route,
    screen_coefficients,
    split_bf16x3,
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
    lowest centroid index across chunks and lanes. One launch of
    ``pqv_assign``, or where ``f32_route`` takes the screen one screen (which
    certifies no tied row) and the re-score of the rows it leaves."""
    x, c, distinct = _grid_blobs(n, d, k, seed=n + d + k)
    xt = torch.from_numpy(x).to(cuda_device)
    ct = torch.from_numpy(c).to(cuda_device)
    before = dict(_build.LAUNCHES)
    got = assign_rows(xt, ct)
    torch.cuda.synchronize()
    made = {key: _build.LAUNCHES[key] - before[key] for key in before}
    if ka.f32_route(n, d, k, xt.data_ptr()) == "screen":
        assert made["K1_f32_screen"] == 1 and made["K1_f32_rescore"] >= 1
        assert made["K1"] == 1 + made["K1_f32_rescore"]
    else:
        assert made["K1"] == 1 and made["K1_f32_screen"] == 0
    assert torch.equal(got, assign_rows_plain(xt, ct))
    assert int(got.max()) < distinct


# ---------------------------------------------------------------- K1 on bf16 rows: the screen

U, U2 = 2.0**-24, 2.0**-23


def _f32_bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def test_split_is_exact_bit_for_bit():
    """hi + mid + lo == c in f32 over seeded normals, values on and one f32
    ulp either side of the midpoints between neighbouring bf16 values (where
    the first cast rounds to even), negatives and zeros (-0 comes back +0)."""
    rng = np.random.default_rng(21)
    normals = rng.standard_normal(4096).astype(np.float32) * np.float32(2.0) ** rng.integers(
        -60, 60, 4096).astype(np.float32)
    base = torch.from_numpy(rng.standard_normal(512).astype(np.float32)).bfloat16()
    nxt = (base.view(torch.int16) + 1).view(torch.bfloat16)
    mids = (base.float() + nxt.float()) / 2  # exact: 9 significant bits
    edges = torch.cat([mids, torch.nextafter(mids, torch.full_like(mids, np.inf)),
                       torch.nextafter(mids, torch.full_like(mids, -np.inf))])
    c = torch.cat([torch.from_numpy(normals), -torch.from_numpy(normals), edges,
                   torch.zeros(8), -torch.zeros(8)]).reshape(-1, 8)
    pieces = split_bf16x3(c)
    assert pieces.dtype == torch.bfloat16 and pieces.shape == (3, *c.shape)
    back = (pieces[0].float() + pieces[1].float()) + pieces[2].float()
    np.testing.assert_array_equal(_f32_bits(back.numpy() + 0.0), _f32_bits(c.numpy() + 0.0))
    # each piece is at most half a bf16 spacing of what it leaves
    assert bool((pieces[1].float().abs() <= c.abs() * 2.0**-8).all())


def test_split_below_the_range_leaves_a_residual_that_the_bound_counts():
    """Under |c| = 2^-110 the last piece falls below bf16's least subnormal
    (2^-133): the sum misses c, by less than 2^-133, and
    ``screen_coefficients`` adds twice that residual's norm to alpha."""
    c = torch.tensor([[2.0**-120 * (1 + 2.0**-20), 1.0], [3.0, 2.0**-115 * 1.75 + 2.0**-138]],
                     dtype=torch.float32)
    pieces = split_bf16x3(c)
    back = (pieces[0].float() + pieces[1].float()) + pieces[2].float()
    miss = (c.double() - back.double()).abs()
    assert float(miss.max()) > 0.0 and float(miss.max()) < 2.0**-133
    cn = (c * c).sum(1)
    _, alpha, _ = screen_coefficients(c, cn, pieces)
    exact = torch.tensor([[0.5, 1.0], [3.0, 1.0]])
    _, alpha0, _ = screen_coefficients(exact, (exact * exact).sum(1), split_bf16x3(exact))
    assert alpha >= 2.0 * float(miss.norm(dim=1).max())
    assert split_bf16x3(exact)[2].abs().max() == 0 and alpha0 > 0


def _gamma(m, u):
    return m * u / (1 - m * u)


def _fma_dot_f32(x, c):
    """K1 f32's sum: sequential fmaf from zero over the dimensions, for
    every (row, centroid) pair; x [p, d] and c [p, d] float32. The products
    of a bf16 value and an f32 value are exact in f64."""
    s = np.zeros(x.shape[0], np.float32)
    for i in range(x.shape[1]):
        s = (x[:, i].astype(np.float64) * c[:, i].astype(np.float64)
             + s.astype(np.float64)).astype(np.float32)
    return s


def _screen_dot_f32(x, pieces):
    """The screen's sum under one instance of its model: a stage's 192
    exact products added in f32 from zero, lo's first and hi's last, the
    stages added in f32."""
    acc = np.zeros(x.shape[0], np.float32)
    for d0 in range(0, x.shape[1], 64):
        part = np.zeros(x.shape[0], np.float32)
        for p in (2, 1, 0):
            for i in range(d0, min(d0 + 64, x.shape[1])):
                part = part + x[:, i] * pieces[p][:, i]
        acc = acc + part
    return acc


def _exact_dot(x, c):
    return np.array([math.fsum(a * b) for a, b in zip(x.astype(np.float64),
                                                       c.astype(np.float64))])


@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("data", ["seeded", "cancelling"])
def test_error_bound_holds_against_float64(d, data):
    """Both halves of the certificate's E against float64: the f32 form's
    value (sequential fmaf) within E_f, the screen's (the three-piece sum)
    within E_s, for every (row, centroid) pair, and E_f + E_s within
    ``alpha_w X_w + alpha X + beta``. Cancelling data: pairs of dimensions,
    scaled over 2^-10 .. 2^10, whose products nearly cancel, so x.c is small
    beside sum |x_i c_i|."""
    rng = np.random.default_rng(d + len(data))
    n, k = 24, 16
    x = rng.standard_normal((n, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    if data == "cancelling":  # dimension 2j + 1 nearly undoes dimension 2j
        scale = np.repeat(2.0 ** rng.uniform(-10, 10, d // 2), 2).astype(np.float32)
        x = np.abs(x) * scale
        x[:, 1::2] = x[:, ::2]
        c = np.abs(c) * scale
        c[:, 1::2] = -c[:, ::2] * (1 + 2.0**-12 * rng.standard_normal((k, d // 2))).astype(
            np.float32)
    x = torch.from_numpy(x).bfloat16().float().numpy()
    ct = torch.from_numpy(c)
    pieces = split_bf16x3(ct).float().numpy()
    cn = (ct * ct).sum(1)
    alpha_w, alpha, beta = screen_coefficients(ct, cn, split_bf16x3(ct))
    rows, cols = np.meshgrid(np.arange(n), np.arange(k), indexing="ij")
    rows, cols = rows.ravel(), cols.ravel()
    xp, cp = x[rows], c[cols]
    t = _exact_dot(xp, cp)
    V = cn.double().numpy()[cols] - 2.0 * t
    cnp = cn.numpy()[cols]
    v_f = (cnp.astype(np.float64) - 2.0 * _fma_dot_f32(xp, cp)).astype(np.float32)
    v_s = (cnp.astype(np.float64) - 2.0 * _screen_dot_f32(
        xp, [pc[cols] for pc in pieces])).astype(np.float32)
    x64 = x.astype(np.float64)
    X = np.linalg.norm(x64, axis=1)[rows]
    X_w = np.linalg.norm(x64 * np.arange(d, 0, -1), axis=1)[rows]
    C = float(np.linalg.norm(c.astype(np.float64), axis=1).max())
    P = float(np.linalg.norm(np.abs(pieces).sum(0).astype(np.float64), axis=1).max())
    H, M, L = (float(np.linalg.norm(pc.astype(np.float64), axis=1).max()) for pc in pieces)
    CN = float(cn.double().max())
    g = U / (1 - d * U)
    g_n = _gamma(-(-d // 64), U)
    e = ((_gamma(68, U2) * H + _gamma(136, U2) * M + _gamma(204, U2) * L) * (1 + g_n)
         + g_n * (1 + _gamma(204, U2)) * P)
    e_f = 2 * g * X_w * C + U * (CN + 2 * X * C + 2 * g * X_w * C)
    e_s = 2 * e * X + U * (CN + 2 * X * C + 2 * e * X)
    assert (np.abs(v_f - V) <= e_f).all()
    assert (np.abs(v_s - V) <= e_s).all()
    assert (e_f + e_s <= alpha_w * X_w + alpha * X + beta).all()
    if data == "cancelling":  # the data does cancel: x.c far below sum |x_i c_i|
        assert np.median(np.abs(t) / (np.abs(xp) * np.abs(cp)).sum(1)) < 0.2


@pytest.mark.parametrize("n,d,k", [(300, 128, 64), (200, 1024, 50), (513, 96, 130)])
def test_screened_plain_equals_plain_and_pallas(n, d, k):
    """The plain screen on bf16 rows gives ``assign_rows_plain``'s ids on
    every row, and the JAX kernel's on the widened rows wherever the two
    best float64 scores differ by more than 1e-5 relative; most rows are
    certified."""
    x, c = _blobs(n, d, k, seed=n + d)
    x16 = torch.from_numpy(x).bfloat16()
    ct = torch.from_numpy(c)
    ids, cert = assign_rows_screened_plain(x16, ct)
    assert ids.dtype == torch.int32 and cert.dtype == torch.bool
    assert torch.equal(ids, assign_rows_plain(x16, ct))
    xw = x16.float().numpy()
    want = assign_clusters_pallas(xw, c, tile=128, interpret=True)
    s = (c.astype(np.float64) ** 2).sum(1)[None, :] - 2.0 * xw.astype(np.float64) @ c.T.astype(
        np.float64)
    two = np.sort(s, axis=1)[:, :2]
    clear = two[:, 1] - two[:, 0] > 1e-5 * (np.abs(two[:, 0]) + (xw.astype(np.float64) ** 2).sum(1))
    np.testing.assert_array_equal(ids.numpy()[clear], want[clear])
    assert float(cert.float().mean()) > 0.9


def test_planted_ties_are_uncertified_and_take_the_lowest_id():
    """Rows equidistant from two centroids (a centroid repeated) and rows
    whose two best f32 values differ by at most one ulp (a centroid moved
    by one ulp in one coordinate) are never certified; the repeated ones go
    to the lowest id."""
    rng = np.random.default_rng(8)
    d, k = 128, 40
    c = rng.standard_normal((k, d)).astype(np.float32)
    c[7] = c[3]  # 3 and 7 tie for every row
    c[11] = c[5]
    c[11, -1] = np.nextafter(c[5, -1], np.float32(np.inf))  # 5 and 11 one ulp apart
    x = np.concatenate([c[3] + 0.01 * rng.standard_normal((20, d)),
                        c[5] + 0.01 * rng.standard_normal((20, d)),
                        rng.standard_normal((60, d))]).astype(np.float32)
    x16 = torch.from_numpy(x).bfloat16()
    ct = torch.from_numpy(c)
    ids, cert = assign_rows_screened_plain(x16, ct)
    assert (ids[:20] == 3).all() and not cert[:20].any()
    near = ids[20:40]
    assert ((near == 5) | (near == 11)).all() and not cert[20:40].any()
    assert torch.equal(ids, assign_rows_plain(x16, ct))
    assert cert[40:].float().mean() > 0.9


@pytest.mark.parametrize("d,k,addresses,want", [
    (1024, 1000, (0, 4096), "screen"), (128, 1024, (16,), "screen"),
    (128, 128, (0,), "screen"), (120, 1000, (0,), "screen"), (1024, 127, (0,), "screen"),
    (1020, 1000, (0,), "fma"), (96, 4096, (0,), "screen"), (3, 1000, (0,), "fma"),
    (1024, 1000, (0, 8), "fma"), (1024, 1, (0,), "screen"), (64, 1000, (0,), "screen"),
    (56, 1000, (0,), "fma"), (32, 4096, (0,), "fma"),
])
def test_bf16_route_is_a_rule_on_shapes(d, k, addresses, want):
    """The screen where d % 8 == 0, d >= SCREEN_MIN_DIM and every array is
    16-byte aligned, whatever k; the FMA form otherwise."""
    assert ka.SCREEN_MIN_DIM == 64
    assert bf16_route(d, k, *addresses) == want


@pytest.mark.parametrize("d", [64, 80, 96, 128, 300, 512, 1024, 4096])
def test_rescore_all_is_the_break_even_rule(d):
    """After the probe, the FMA form takes every row exactly where more of
    the probed rows were left uncertified than ``RESCORE_BREAK_EVEN`` allows
    at d: linear between its points, from ``SCREEN_MIN_DIM`` up, the last
    point's share beyond it."""
    dims, shares = zip(*ka.RESCORE_BREAK_EVEN)
    assert dims == tuple(sorted(dims)) and dims[0] == ka.SCREEN_MIN_DIM
    assert all(0.0 <= v < 1.0 for v in shares) and ka.PROBE_ROWS == 65536
    assert ka.RESCORE_BREAK_EVEN == ((64, 0.08), (96, 0.25), (128, 0.32), (512, 0.66),
                                     (1024, 0.71))
    share = float(np.interp(d, dims, shares))
    probed = ka.PROBE_ROWS
    cut = math.floor(share * probed)
    assert not ka.rescore_all(cut, probed, d)
    assert ka.rescore_all(cut + 1, probed, d) and ka.rescore_all(probed, probed, d)


def _edge_rows(n, d, k, seed):
    """Rows whose 16 products in every k16 step span 2^24 (elements +-m
    2^-e, m in [1, 2), e from 0 to 24 across the step), and seeded normal
    centroids: the edge of the screen's tensor-core model."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    scale = torch.exp2(-torch.round(torch.arange(16) * 24.0 / 15.0)).repeat(d // 16)
    sign = torch.randint(0, 2, (n, d), generator=gen) * 2.0 - 1.0
    x16 = (sign * (1.0 + torch.rand(n, d, generator=gen)) * scale).bfloat16()
    return x16, torch.randn(k, d, generator=gen)


@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("data", ["edge", "seeded"])
def test_plain_screen_values_within_the_model_bound(d, data):
    """``screen_value_bound`` is the model's bound row by row: the plain
    screen's values (f32 matmuls, an instance of the model) stay within it
    for every (row, centroid) pair, on rows at the model's edge and on
    seeded blobs; the bound is tight enough to mean something (its mean
    under 1e-4 of |x| max|c|) and the exact value it returns is float64's."""
    if data == "edge":
        x16, c = _edge_rows(64, d, 24, seed=d)
    else:
        x, cn_ = _blobs(64, d, 24, seed=d)
        x16, c = torch.from_numpy(x).bfloat16(), torch.from_numpy(cn_)
    cn = (c * c).sum(1)
    values = ka.screen_values_plain(x16, c)
    pieces = split_bf16x3(c)
    for j in range(c.shape[0]):
        ids = torch.full((x16.shape[0],), j)
        exact, bound = ka.screen_value_bound(x16, pieces, cn, ids)
        assert bool(((values[:, j].double() - exact).abs() <= bound).all())
        want = cn.double()[j] - 2.0 * torch.from_numpy(_exact_dot(
            x16.float().numpy(), np.repeat(c[j : j + 1].numpy(), x16.shape[0], 0)))
        assert torch.allclose(exact, want, rtol=0, atol=1e-9 * float(want.abs().max()))
        scale = x16.double().norm(dim=1) * float(c.double().norm(dim=1).max())
        assert float((bound / scale).mean()) < 1e-4


def test_bf16_forms_shared_memory():
    """The FMA form's stage is K1 f32's and the rows' raw bf16 (32 bytes a
    row), beside each thread's 8 running (score, id) pairs; two blocks fit
    an SM. The screen's stage holds the rows once and three pieces of the
    centroids (64 KB): one block an SM."""
    fma = score_tile.smem_bytes("K1", "fma_bf16", 128)
    assert fma == score_tile.smem_bytes("K1", "fma", 128) + 3 * 128 * 32 + 8 * 256 * 8
    assert 2 * (fma + 1024) <= score_tile.SMEM_PER_SM
    screen = score_tile.smem_bytes("K1", "screen", 128)
    assert screen == 1024 + 3 * 65536 + 1024 <= score_tile.SMEM_LIMIT
    assert score_tile.wave_blocks(screen) == score_tile.SM_COUNT


def test_bf16_rows_on_cpu_launch_nothing_and_count_no_screen():
    x16 = torch.from_numpy(_blobs(300, 128, 130, seed=4)[0]).bfloat16()
    c = torch.from_numpy(_blobs(300, 128, 130, seed=4)[1])
    before, screened = dict(_build.LAUNCHES), dict(ka.SCREENED)
    assert torch.equal(assign_rows(x16, c), assign_rows_plain(x16, c))
    assert _build.LAUNCHES == before and ka.SCREENED == screened


@pytest.mark.parametrize("case", ["cpu", "f32 rows", "f64 norms", "width", "strided",
                                  "f64 rows"])
def test_screen_rejects_what_it_cannot_take(case):
    """The screen runs on the card only, on contiguous bf16 or f32 rows
    against f32 centroids and their f32 norms of one width; it raises on
    anything else (rows on the CPU, of either dtype, among it) before it
    reaches the library."""
    x = torch.zeros(4, 16, dtype=torch.bfloat16)
    c = torch.zeros(3, 16)
    cn = torch.zeros(3)
    if case == "f32 rows":
        x = x.float()
    elif case == "f64 rows":
        x = x.double()
    elif case == "f64 norms":
        cn = cn.double()
    elif case == "width":
        c = torch.zeros(3, 8)
    elif case == "strided":
        x = torch.zeros(4, 32, dtype=torch.bfloat16)[:, ::2]
    with pytest.raises(ValueError):
        ka.screen(x, c, cn)


@pytest.mark.cuda
def test_bf16_forms_shared_memory_agree_with_sources(cuda_device):
    lib = _build.load()
    assert lib.pqv_assign_bf16_smem(0) == score_tile.smem_bytes("K1", "fma_bf16", 128)
    assert lib.pqv_assign_bf16_smem(1) == score_tile.smem_bytes("K1", "screen", 128)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["fma", "screen"])
@pytest.mark.parametrize("n,d,k", [(1, 3, 1), (1001, 3, 1000), (1, 8, 1), (1001, 8, 1000),
                                   (1001, 96, 1), (1, 96, 1000), (1001, 1024, 1000),
                                   (1, 1024, 1), (257, 1024, 1000)])
def test_bf16_forms_equal_k1_f32_on_card(cuda_device, route, n, d, k):
    """Both bf16-row forms give K1 f32's ids over the widened rows, bit for
    bit, on continuous data and on grid data whose rows all tie (every
    centroid repeated): the screen certifies none of those, the re-score
    takes the lowest id. Launches: one screen and at most one re-score, or
    one FMA form."""
    if route == "screen" and d % 8:
        pytest.skip("the screen takes d % 8 == 0 only")
    x, c = _blobs(n, d, k, seed=n + d + k)
    gx, gc, distinct = _grid_blobs(n, d, k, seed=n + d)
    for xs, cs_ in ((x, c), (gx, gc)):
        x16 = torch.from_numpy(xs).to(cuda_device).bfloat16()
        ct = torch.from_numpy(cs_).to(cuda_device)
        before = dict(_build.LAUNCHES)
        got = ka._assign_cuda(x16, ct, route=route)
        torch.cuda.synchronize()
        made = {key: _build.LAUNCHES[key] - before[key] for key in before}
        if route == "fma":
            assert made["K1_bf16"] == 1 and made["K1_bf16_screen"] == 0
        else:
            assert made["K1_bf16_screen"] == 1 and made["K1_bf16_rescore"] <= 1
            assert made["K1_bf16"] == 1 + made["K1_bf16_rescore"]
        assert torch.equal(got, assign_rows(x16.float(), ct))
    assert int(got.max()) < distinct


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(128, 1024), (1024, 1000)])
def test_screen_values_within_the_model_bound_on_card(cuda_device, d, k):
    """At the edge of the model (``_edge_rows``): every screen value on the
    card within ``screen_value_bound`` of its row's products; certified ids
    and the route's ids are K1 f32's over the widened rows."""
    x16, c = (t.to(cuda_device) for t in _edge_rows(4096, d, k, seed=d))
    cn = (c * c).sum(1).contiguous()
    ids, flags, values = ka.screen(x16, c, cn, values=True)
    exact, bound = ka.screen_value_bound(x16, split_bf16x3(c), cn, ids)
    assert bool(((values.double() - exact).abs() <= bound).all())
    want = assign_rows(x16.float(), c)
    assert torch.equal(ids[flags.bool()], want[flags.bool()])
    assert torch.equal(assign_rows(x16, c), want)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
def test_probe_routes_by_the_share_it_reads_on_card(cuda_device, ties):
    """A call of more than 2 ``PROBE_ROWS`` rows screens the probe first: on
    blobs the screen then takes the rest (two screens, at most one
    re-score); where every centroid is repeated (every row ties) the probe
    sends the call to the FMA form over all rows (one screen, one FMA form,
    no re-score). The ids are K1 f32's either way."""
    n, d, k = 2 * ka.PROBE_ROWS + 1000, 128, 64
    x, c = _blobs(n, d, k // 2 if ties else k, seed=14)
    if ties:
        c = np.repeat(c, 2, axis=0)
    x16 = torch.from_numpy(x).to(cuda_device).bfloat16()
    ct = torch.from_numpy(c).to(cuda_device)
    ka.reset_screen_counts()
    before = dict(_build.LAUNCHES)
    got = assign_rows(x16, ct)
    torch.cuda.synchronize()
    made = {key: _build.LAUNCHES[key] - before[key] for key in before}
    if ties:
        assert made["K1_bf16_screen"] == 1 and made["K1_bf16_rescore"] == 0
        assert made["K1_bf16"] == 2 and ka.SCREENED["fma_after_probe"] == 1
        assert ka.SCREENED["rows"] == ka.SCREENED["uncertified"] == ka.PROBE_ROWS
    else:
        assert made["K1_bf16_screen"] == 2 and made["K1_bf16_rescore"] <= 1
        assert ka.SCREENED["fma_after_probe"] == 0 and ka.SCREENED["rows"] == n
    assert torch.equal(got, assign_rows(x16.float(), ct))


# ---------------------------------------------------------------- K1 on f32 rows: the screen

from pqvector_tpu_torch.kernels.assign import (  # noqa: E402
    f32_route,
    screen_coefficients_f32,
    split_f32_rows,
)


def _bf16_exact(t):
    return bool((t.bfloat16().float() == t).all())


def test_f32_split_is_exact_bit_for_bit():
    """xh + xm + xr == x in f32 over seeded normals at exponents from 2^-60 to
    2^60, values on and one ulp either side of the midpoints between
    neighbouring bf16 values, negatives and zeros; xh and xm are bf16 values,
    each at most half a bf16 spacing of what it leaves."""
    rng = np.random.default_rng(31)
    normals = rng.standard_normal(4096).astype(np.float32) * np.float32(2.0) ** rng.integers(
        -60, 60, 4096).astype(np.float32)
    base = torch.from_numpy(rng.standard_normal(512).astype(np.float32)).bfloat16()
    mids = (base.float() + (base.view(torch.int16) + 1).view(torch.bfloat16).float()) / 2
    edges = torch.cat([mids, torch.nextafter(mids, torch.full_like(mids, np.inf)),
                       torch.nextafter(mids, torch.full_like(mids, -np.inf))])
    x = torch.cat([torch.from_numpy(normals), -torch.from_numpy(normals), edges,
                   torch.zeros(8), -torch.zeros(8)]).reshape(-1, 8)
    xh, xm, xr = split_f32_rows(x)
    assert _bf16_exact(xh) and _bf16_exact(xm)
    back = (xh + xm) + xr
    np.testing.assert_array_equal(_f32_bits(back.numpy() + 0.0), _f32_bits(x.numpy() + 0.0))
    assert bool((xm.abs() <= x.abs() * 2.0**-8).all())
    assert bool((xr.abs() <= x.abs() * 2.0**-16).all())
    assert float(xr.abs().max()) > 0.0  # 24 bits do not fit in two pieces of 8


def test_f32_split_below_the_range_leaves_a_residual_that_the_bound_counts():
    """A piece that would be under 2^-126 is 0 and stays in the residual
    (no subnormal reaches the tensor cores): values under 2^-126 go whole
    into xr, values near 2^-120 lose xm to it; the row norms the certificate
    reads count xr, and its coefficient a_r is 2 (1 + u) C."""
    tiny = torch.tensor([[2.0**-130 * 1.5, 2.0**-120 * (1 + 2.0**-20), 1.0, -3.0]],
                        dtype=torch.float32)
    xh, xm, xr = split_f32_rows(tiny)
    assert float(xh[0, 0]) == 0.0 and float(xr[0, 0]) == float(tiny[0, 0])
    assert float(xh[0, 1]) == 2.0**-120 and float(xm[0, 1]) == 0.0
    assert float(xr[0, 1]) == float(tiny[0, 1]) - 2.0**-120 > 0.0
    assert bool(((xh.abs() >= 2.0**-126) | (xh == 0)).all())
    assert bool(((xm.abs() >= 2.0**-126) | (xm == 0)).all())
    norms = ka._row_norms(tiny)
    assert float(norms[0, 4]) >= float(xr.double().norm()) > 0.0
    c = torch.tensor([[0.5, 1.0, 2.0, 3.0], [1.0, -1.0, 0.25, 0.0]])
    coef = screen_coefficients_f32(c, (c * c).sum(1), split_bf16x3(c))
    assert coef[4] == pytest.approx(2.0 * (1 + U) * float(c.double().norm(dim=1).max()),
                                    rel=1e-8)


def _screen_dot_f32_rows(x, pieces):
    """The f32-row screen's sum under one instance of its model: a stage's
    products of the three pairs (xm.hi, xh.mid, xh.hi) added in f32 from
    zero, the stages added in f32."""
    xs = split_f32_rows(torch.from_numpy(x)).numpy()
    acc = np.zeros(x.shape[0], np.float32)
    for d0 in range(0, x.shape[1], 64):
        part = np.zeros(x.shape[0], np.float32)
        for p, q in ka.F32_SCREEN_PAIRS:
            for i in range(d0, min(d0 + 64, x.shape[1])):
                part = part + xs[p][:, i] * pieces[q][:, i]
        acc = acc + part
    return acc


@pytest.mark.parametrize("cancelling", [False, True])
@pytest.mark.parametrize("d", [128, 256, 1024])
@pytest.mark.parametrize("spread", [0, 9, 24])
def test_f32_error_bound_holds_against_float64(spread, d, cancelling):
    """Both halves of the f32-row certificate against float64 on every
    (row, centroid) pair: ``pqv_assign``'s value (sequential fmaf) within its
    own E_f, and the f32-row screen's (the three pairs of pieces) within the
    rest of ``alpha_w X_w + alpha X + a_h X_h + a_m X_m + a_r X_r + beta``, so
    the two lie within that E of each other. Rows scaled over 2^-spread ..
    2^spread per dimension, and with ``cancelling`` pairs of dimensions whose
    products nearly cancel; the data seeded from the case."""
    rng = np.random.default_rng(1000 * spread + d + int(cancelling))
    n, k = 6, 8
    scale = (2.0 ** rng.uniform(-spread, spread, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32) * scale
    c = rng.standard_normal((k, d)).astype(np.float32)
    if cancelling:  # dimension 2j + 1 nearly undoes dimension 2j
        x = np.abs(x)
        x[:, 1::2] = x[:, ::2]
        c = np.abs(c)
        c[:, 1::2] = -c[:, ::2] * (1 + 2.0**-12 * rng.standard_normal((k, d // 2))).astype(
            np.float32)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    pieces = split_bf16x3(ct).float().numpy()
    cn = (ct * ct).sum(1)
    alpha_w, alpha, a_h, a_m, a_r, beta, x_limit = screen_coefficients_f32(
        ct, cn, split_bf16x3(ct))
    rows, cols = np.meshgrid(np.arange(n), np.arange(k), indexing="ij")
    rows, cols = rows.ravel(), cols.ravel()
    xp, cp = x[rows], c[cols]
    V = cn.double().numpy()[cols] - 2.0 * _exact_dot(xp, cp)
    cnp = cn.numpy()[cols].astype(np.float64)
    v_f = (cnp - 2.0 * _fma_dot_f32(xp, cp)).astype(np.float32)
    v_s = (cnp - 2.0 * _screen_dot_f32_rows(xp, [pc[cols] for pc in pieces])).astype(
        np.float32)
    norms = ka._row_norms(xt).numpy()[rows]
    X, X_w = norms[:, 0], norms[:, 1]
    C = float(np.linalg.norm(c.astype(np.float64), axis=1).max())
    CN = float(cn.double().max())
    g = U / (1 - d * U)
    e_f = 2 * g * X_w * C + U * (CN + 2 * X * C + 2 * g * X_w * C)
    E = alpha_w * X_w + alpha * X + a_h * norms[:, 2] + a_m * norms[:, 3] + a_r * norms[:, 4] \
        + beta
    assert (X <= x_limit).all()
    assert (np.abs(v_f - V) <= e_f).all()
    assert (np.abs(v_s - V) + e_f <= E).all()
    assert (np.abs(v_f.astype(np.float64) - v_s) <= E).all()


def test_f32_dropped_pairs_are_bounded_row_piece_by_row_piece():
    """What the three pairs leave out, x.c - (xh.(hi + mid) + xm.hi), lies
    within X_h D_2 + X_m D_1 + X_r C for every (row, centroid) pair, with
    D_j the largest norm of c less its first j pieces; and it is of the
    size the certificate expects, about 2^-17 |x| |c|."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((40, 256)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((30, 256)).astype(np.float32))
    xh, xm, xr = split_f32_rows(x).double()
    hi, mid, _ = split_bf16x3(c).double()
    c64 = c.double()
    dropped = (x.double() @ c64.T) - (xh @ (hi + mid).T + xm @ hi.T)
    d1 = float((c64 - hi).norm(dim=1).max())
    d2 = float((c64 - hi - mid).norm(dim=1).max())
    bound = xh.norm(dim=1)[:, None] * d2 + xm.norm(dim=1)[:, None] * d1 \
        + xr.norm(dim=1)[:, None] * float(c64.norm(dim=1).max())
    assert bool((dropped.abs() <= bound).all())
    rel = bound / (x.double().norm(dim=1)[:, None] * c64.norm(dim=1).max())
    assert 2.0**-20 < float(rel.max()) < 2.0**-14


@pytest.mark.parametrize("n,d,k", [(300, 128, 64), (200, 1024, 50), (513, 96, 130),
                                   (1001, 136, 69), (129, 8, 1)])
def test_f32_screened_plain_equals_plain_and_pallas(n, d, k):
    """The plain f32-row screen gives ``assign_rows_plain``'s ids on every
    row and the JAX kernel's wherever the two best float64 scores differ by
    more than 1e-5 relative; most rows are certified."""
    x, c = _blobs(n, d, k, seed=n + d + 7)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    ids, cert = assign_rows_screened_plain(xt, ct)
    assert ids.dtype == torch.int32 and cert.dtype == torch.bool
    assert torch.equal(ids, assign_rows_plain(xt, ct))
    want = assign_clusters_pallas(x, c, tile=128, interpret=True)
    s = (c.astype(np.float64) ** 2).sum(1)[None, :] - 2.0 * x.astype(np.float64) @ c.T.astype(
        np.float64)
    two = np.sort(s, axis=1)[:, :2] if k > 1 else np.concatenate([s, s + 1.0], 1)
    clear = two[:, 1] - two[:, 0] > 1e-5 * (np.abs(two[:, 0]) + (x.astype(np.float64) ** 2).sum(1))
    np.testing.assert_array_equal(ids.numpy()[clear], want[clear])
    assert float(cert.float().mean()) > 0.9


@pytest.mark.parametrize("n,d,k", AWKWARD)
def test_f32_screened_plain_equals_pallas_at_awkward_shapes(n, d, k):
    """Grid data (every score exact, every centroid repeated): the f32-row
    screen certifies no row that ties, and the route's ids are the JAX
    kernel's, ties to the lowest centroid."""
    x, c, distinct = _grid_blobs(n, d, k, seed=n + d + k)
    ids, cert = assign_rows_screened_plain(torch.from_numpy(x), torch.from_numpy(c))
    want = assign_clusters_pallas(x, c, tile=128, interpret=True)
    np.testing.assert_array_equal(ids.numpy(), want)
    assert int(ids.max()) < distinct
    if k > distinct:
        assert not bool(cert.any())


def test_f32_planted_ties_are_uncertified_and_take_the_lowest_id():
    """f32 rows equidistant from two centroids (a centroid repeated) and rows
    whose two best values differ by about an ulp (a centroid moved by one
    ulp in one coordinate) are never certified; the repeated ones go to the
    lowest id; the rest are mostly certified."""
    rng = np.random.default_rng(18)
    d, k = 256, 40
    c = rng.standard_normal((k, d)).astype(np.float32)
    c[7] = c[3]
    c[11] = c[5]
    c[11, -1] = np.nextafter(c[5, -1], np.float32(np.inf))
    x = np.concatenate([c[3] + 0.01 * rng.standard_normal((20, d)),
                        c[5] + 0.01 * rng.standard_normal((20, d)),
                        rng.standard_normal((60, d))]).astype(np.float32)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    ids, cert = assign_rows_screened_plain(xt, ct)
    assert (ids[:20] == 3).all() and not cert[:20].any()
    assert ((ids[20:40] == 5) | (ids[20:40] == 11)).all() and not cert[20:40].any()
    assert torch.equal(ids, assign_rows_plain(xt, ct))
    assert cert[40:].float().mean() > 0.9


M = 1_000_000


@pytest.mark.parametrize("n,d,k,addresses,want", [
    (M, 1024, 1000, (0, 4096), "screen"), (M, 128, 1024, (16,), "screen"),
    (M, 96, 4096, (0,), "fma"), (M, 1024, 1, (0,), "fma"), (M, 136, 69, (0,), "fma"),
    (M, 120, 1000, (0,), "fma"), (M, 64, 1000, (0,), "fma"), (M, 1020, 1000, (0,), "fma"),
    (M, 1024, 1000, (0, 8), "fma"), (M, 3, 1000, (0,), "fma"), (M, 32, 4096, (0,), "fma"),
    (8 * M, 136, 69, (0,), "screen"), (50_000, 128, 1024, (0,), "fma"),
    (50_000, 1024, 1000, (0,), "fma"), (12_500, 1024, 1000, (0,), "fma"),
    (62_500, 1024, 1000, (0,), "screen"), (400_000, 128, 1024, (0,), "fma"),
    (500_000, 128, 1024, (0,), "screen"), (131_072, 128, 1024, (0,), "fma"),
])
def test_f32_route_is_a_rule_on_shapes(n, d, k, addresses, want):
    """The f32-row screen where d % 8 == 0, d >= F32_SCREEN_MIN_DIM (128:
    the route loses to ``pqv_assign`` at 32 and 64 on the H100 and at 96 by
    the run), every array is 16-byte aligned and the call's work n k d is
    at least F32_SCREEN_MIN_WORK (Lloyd's 50,000-row sample and a streaming
    build's 131,072-row batch at 128 x 1024 stay on ``pqv_assign``);
    ``pqv_assign`` otherwise."""
    assert ka.F32_SCREEN_MIN_DIM == 128 and ka.F32_SCREEN_MIN_WORK == 6.4e10
    assert f32_route(n, d, k, *addresses) == want


@pytest.mark.parametrize("d", [128, 136, 300, 512, 768, 1024, 4096])
def test_rescore_all_f32_is_the_break_even_rule(d):
    """After the probe of f32 rows, ``pqv_assign`` takes every row exactly
    where more of the probed rows were left uncertified than
    ``RESCORE_BREAK_EVEN_F32`` allows at d, linear between its points from
    ``F32_SCREEN_MIN_DIM`` up; its shares lie under the bf16 rows' (the
    f32-row screen costs more beside its FMA form)."""
    table = ka.RESCORE_BREAK_EVEN_F32
    dims, shares = zip(*table)
    assert dims == tuple(sorted(dims)) and dims[0] == ka.F32_SCREEN_MIN_DIM
    assert all(0.0 <= v < 1.0 for v in shares)
    assert all(v <= float(np.interp(dd, *zip(*ka.RESCORE_BREAK_EVEN))) for dd, v in table)
    share = float(np.interp(d, dims, shares))
    probed = ka.PROBE_ROWS
    cut = math.floor(share * probed)
    assert not ka.rescore_all(cut, probed, d, table)
    assert ka.rescore_all(cut + 1, probed, d, table) and ka.rescore_all(probed, probed, d, table)


def _edge_rows_f32(n, d, k, seed):
    """``_edge_rows`` with f32 elements: 24 significant bits each, so both
    row pieces are at work, and products spanning 2^24 in every k16 step."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    scale = torch.exp2(-torch.round(torch.arange(16) * 24.0 / 15.0)).repeat(d // 16)
    sign = torch.randint(0, 2, (n, d), generator=gen) * 2.0 - 1.0
    return (sign * (1.0 + torch.rand(n, d, generator=gen)) * scale,
            torch.randn(k, d, generator=gen))


@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("data", ["edge", "seeded"])
def test_f32_plain_screen_values_within_the_model_bound(d, data):
    """``screen_value_bound`` on f32 rows: the plain f32-row screen's values
    (f32 matmuls over the pairs, an instance of the model) within it of
    ``|c|^2 - 2 (xh.(hi + mid) + xm.hi)`` for every (row, centroid) pair, on
    edge and seeded rows; the bound means something (its mean under 1e-4 of
    |x| max|c|) and the value it returns is float64's."""
    if data == "edge":
        x, c = _edge_rows_f32(48, d, 16, seed=d + 1)
    else:
        xb, cb = _blobs(48, d, 16, seed=d + 2)
        x, c = torch.from_numpy(xb), torch.from_numpy(cb)
    cn = (c * c).sum(1)
    values = ka.screen_values_plain(x, c)
    pieces = split_bf16x3(c)
    xh, xm, _ = split_f32_rows(x).double()
    hi, mid, _ = pieces.double()
    kept = xh @ (hi + mid).T + xm @ hi.T
    for j in range(c.shape[0]):
        ids = torch.full((x.shape[0],), j)
        exact, bound = ka.screen_value_bound(x, pieces, cn, ids)
        assert bool(((values[:, j].double() - exact).abs() <= bound).all())
        want = cn.double()[j] - 2.0 * kept[:, j]
        assert torch.allclose(exact, want, rtol=0, atol=1e-9 * float(want.abs().max()))
        scale = x.double().norm(dim=1) * float(c.double().norm(dim=1).max())
        assert float((bound / scale).mean()) < 1e-4


def test_f32_screen_shared_memory():
    """The f32-row screen's stage holds two bf16 pieces of the rows (staged
    raw as f32, split in place) and two of the centroids: 64 KB, three
    stages, one block an SM."""
    smem = score_tile.smem_bytes("K1", "screen_f32", 128)
    assert smem == 1024 + 3 * 65536 + 1024 <= score_tile.SMEM_LIMIT
    assert score_tile.wave_blocks(smem) == score_tile.SM_COUNT


def test_f32_rows_on_cpu_launch_nothing_and_count_no_screen():
    x, c = _blobs(300, 128, 130, seed=41)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    before, screened = dict(_build.LAUNCHES), dict(ka.SCREENED)
    assert torch.equal(assign_rows(xt, ct), assign_rows_plain(xt, ct))
    assert _build.LAUNCHES == before and ka.SCREENED == screened


class _StandInLibrary:
    """The kernel library's K1 entry points over CPU memory, by the plain
    versions: the route's control flow (probe, break-even, blocked
    re-score, counters) runs without a card."""

    @staticmethod
    def _array(ptr, count, ctype):
        import ctypes
        return np.ctypeslib.as_array((ctype * count).from_address(ptr))

    def pqv_assign(self, xp, cp, cnp, n, d, k, outp, stream):
        import ctypes
        x = torch.from_numpy(self._array(xp, n * d, ctypes.c_float).reshape(n, d).copy())
        c = torch.from_numpy(self._array(cp, k * d, ctypes.c_float).reshape(k, d).copy())
        self._array(outp, n, ctypes.c_int32)[:] = assign_rows_plain(x, c).numpy()
        return 0

    #: csrc/score_tile.cuh's pairs: xm.hi, xh.mid, xh.hi
    pairs = ((1, 0), (0, 1), (0, 0))

    def pqv_assign_f32_screen_pairs(self, row, centroid):
        for j, (a, q) in enumerate(self.pairs):
            row[j], centroid[j] = a, q
        return len(self.pairs)

    def pqv_assign_f32_screen(self, xp, pp, cnp, n, d, k, coef, outp, fp, vp, stream):
        import ctypes
        x = torch.from_numpy(self._array(xp, n * d, ctypes.c_float).reshape(n, d).copy())
        bits = self._array(pp, 3 * k * d, ctypes.c_uint16).reshape(3, k, d).astype(np.int32)
        pieces = torch.from_numpy((bits << 16).view(np.float32).copy())
        c = (pieces[0] + pieces[1]) + pieces[2]
        ids, cert = ka._certified(x, ka.screen_values_plain(x, c), tuple(coef))
        self._array(outp, n, ctypes.c_int32)[:] = ids.numpy()
        self._array(fp, n, ctypes.c_uint8)[:] = cert.numpy()
        return 0


@pytest.mark.parametrize("ties", [False, True])
def test_f32_route_control_flow_with_a_stand_in_library(monkeypatch, ties):
    """``_assign_cuda``'s f32-row route against a stand-in for the kernel
    library on CPU memory: on blobs the probe's share keeps the screen (two
    screens, the re-score in blocks of whole waves when ``RESCORE_BLOCK_BYTES``
    is small); where every centroid is repeated the probe sends the call to
    ``pqv_assign`` over every row; the ids are the plain version's, the
    counters the f32 rows'."""
    monkeypatch.setattr(_build, "load", lambda: _StandInLibrary())
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_build, "check", lambda rc, name: None)
    monkeypatch.setattr(score_tile, "SM_COUNT", 1)   # waves of 256 rows
    monkeypatch.setattr(ka, "RESCORE_BLOCK_BYTES", 4 * 128 * 300)
    x, c = _blobs(2600, 128, 20 if ties else 40, seed=3)
    if ties:
        c = np.repeat(c, 2, axis=0)
    else:  # near ties past the probe: rows halfway between two centroids
        x[-600:] = (c[0] + c[1]) / 2 + 1e-6 * np.random.default_rng(4).standard_normal(
            (600, 128)).astype(np.float32)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    before = dict(_build.LAUNCHES)
    ka.reset_screen_counts()
    got = ka._assign_cuda(xt, ct, route="screen", probe=1000)
    made = {key: _build.LAUNCHES[key] - before[key] for key in before}
    assert torch.equal(got, assign_rows_plain(xt, ct))
    assert ka.SCREENED["rows"] == ka.SCREENED["uncertified"] == 0
    if ties:
        assert made == {**{key: 0 for key in made}, "K1": 2, "K1_f32_screen": 1}
        assert ka.SCREENED["f32_fma_after_probe"] == 1
        assert ka.SCREENED["f32_rows"] == ka.SCREENED["f32_uncertified"] == 1000
    else:
        rest = ka.SCREENED["f32_uncertified"]
        assert ka.SCREENED["f32_rows"] == 2600 and 600 <= rest < 2600 * 0.3
        assert made["K1_f32_screen"] == 2 and made["K1_f32_rescore"] == -(-rest // 256)
        assert made["K1"] == 2 + made["K1_f32_rescore"] and made["K1_bf16"] == 0


def test_f32_screen_refuses_a_library_whose_pairs_differ(monkeypatch):
    """The certificate is computed from ``F32_SCREEN_PAIRS``: a library
    whose screen sums other pairs (here six, a third piece of both) makes
    the f32-row route raise before it launches the screen; the stand-in
    with the kernel's three pairs runs."""

    class SixPairs(_StandInLibrary):
        pairs = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))

    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_build, "check", lambda rc, name: None)
    x, c = _blobs(300, 128, 40, seed=8)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    monkeypatch.setattr(_build, "load", lambda: SixPairs())
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="pairs"):
        ka._assign_cuda(xt, ct, route="screen", probe=0)
    assert _build.LAUNCHES == before
    monkeypatch.setattr(_build, "load", lambda: _StandInLibrary())
    assert torch.equal(ka._assign_cuda(xt, ct, route="screen", probe=0),
                       assign_rows_plain(xt, ct))


@pytest.mark.cuda
def test_f32_screen_shared_memory_agrees_with_sources(cuda_device):
    """The built f32-row screen's shared memory and its pairs are the ones
    the wrapper reckons with (``smem_bytes``, ``F32_SCREEN_PAIRS``)."""
    lib = _build.load()
    assert lib.pqv_assign_f32_screen_smem() == score_tile.smem_bytes("K1", "screen_f32", 128)
    assert ka.kernel_pairs(lib) == ka.F32_SCREEN_PAIRS


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,k", [(1, 96, 1), (1001, 96, 1000), (1, 1024, 1),
                                   (1001, 1024, 1000), (257, 128, 1024), (383, 136, 69),
                                   (129, 8, 3)])
def test_f32_screen_equals_pqv_assign_on_card(cuda_device, n, d, k):
    """The f32-row route (unprobed and through the probe) and the screen's
    certified ids equal ``pqv_assign``'s over every row, bit for bit, on
    continuous data and on grid data whose rows all tie; one screen, and
    the re-score of what it leaves."""
    x, c = _blobs(n, d, k, seed=n + d + k)
    gx, gc, _ = _grid_blobs(n, d, k, seed=n + d)
    for xs, cs_ in ((x, c), (gx, gc)):
        xt = torch.from_numpy(xs).to(cuda_device)
        ct = torch.from_numpy(cs_).to(cuda_device)
        want = ka._assign_cuda(xt, ct, route="fma")
        before = dict(_build.LAUNCHES)
        got = ka._assign_cuda(xt, ct, route="screen", probe=0)
        torch.cuda.synchronize()
        made = {key: _build.LAUNCHES[key] - before[key] for key in before}
        assert made["K1_f32_screen"] == 1 and made["K1"] == 1 + made["K1_f32_rescore"]
        assert torch.equal(got, want)
        assert torch.equal(ka._assign_cuda(xt, ct, probe=max(1, n // 3)), want)
        ids, flags, _ = ka.screen(xt, ct, (ct * ct).sum(1).contiguous())
        cert = flags.bool()
        assert torch.equal(ids[cert], want[cert])


@pytest.mark.cuda
@pytest.mark.parametrize("d,k", [(128, 1024), (1024, 1000)])
def test_f32_screen_values_within_the_model_bound_on_card(cuda_device, d, k):
    """At the edge of the model (``_edge_rows_f32``): every f32-row screen
    value on the card within ``screen_value_bound`` of its row's products;
    certified ids and the route's ids are ``pqv_assign``'s."""
    x, c = (t.to(cuda_device) for t in _edge_rows_f32(4096, d, k, seed=d))
    cn = (c * c).sum(1).contiguous()
    ids, flags, values = ka.screen(x, c, cn, values=True)
    exact, bound = ka.screen_value_bound(x, split_bf16x3(c), cn, ids)
    assert bool(((values.double() - exact).abs() <= bound).all())
    want = ka._assign_cuda(x, c, route="fma")
    assert torch.equal(ids[flags.bool()], want[flags.bool()])
    assert torch.equal(assign_rows(x, c), want)


@pytest.mark.cuda
@pytest.mark.parametrize("ties", [False, True])
def test_f32_probe_routes_by_the_share_it_reads_on_card(cuda_device, ties):
    """A call of more than 2 ``PROBE_ROWS`` f32 rows screens the probe
    first: on blobs the screen then takes the rest; where every centroid is
    repeated the probe sends the call to ``pqv_assign`` over all rows (one
    screen, one ``pqv_assign``, no re-score). The ids are ``pqv_assign``'s
    either way."""
    n, d, k = 2 * ka.PROBE_ROWS + 1000, 128, 4096
    assert ka.f32_route(n, d, k, 0) == "screen"
    x, c = _blobs(n, d, k // 2 if ties else k, seed=15)
    if ties:
        c = np.repeat(c, 2, axis=0)
    xt = torch.from_numpy(x).to(cuda_device)
    ct = torch.from_numpy(c).to(cuda_device)
    ka.reset_screen_counts()
    before = dict(_build.LAUNCHES)
    got = assign_rows(xt, ct)
    torch.cuda.synchronize()
    made = {key: _build.LAUNCHES[key] - before[key] for key in before}
    if ties:
        assert made["K1_f32_screen"] == 1 and made["K1_f32_rescore"] == 0
        assert made["K1"] == 2 and ka.SCREENED["f32_fma_after_probe"] == 1
        assert ka.SCREENED["f32_rows"] == ka.SCREENED["f32_uncertified"] == ka.PROBE_ROWS
    else:
        assert made["K1_f32_screen"] == 2 and ka.SCREENED["f32_fma_after_probe"] == 0
        assert ka.SCREENED["f32_rows"] == n
    assert torch.equal(got, ka._assign_cuda(xt, ct, route="fma"))


def test_f32_rows_whose_sums_could_overflow_are_not_certified():
    """Rows so large that a sum of either form could reach the f32 range
    (X past ``x_limit``) are never certified, whatever their gap, and take
    the plain version's ids; rows of the same shape at an ordinary scale are
    certified."""
    x, c = _blobs(64, 128, 16, seed=12)
    xt, ct = torch.from_numpy(x), torch.from_numpy(c)
    x_limit = screen_coefficients_f32(ct, (ct * ct).sum(1), split_bf16x3(ct))[-1]
    big = xt * float(2.0 * x_limit / xt.double().norm(dim=1).min())
    ids, cert = assign_rows_screened_plain(big, ct)
    assert not bool(cert.any()) and torch.equal(ids, assign_rows_plain(big, ct))
    assert bool(assign_rows_screened_plain(xt, ct)[1].all())
