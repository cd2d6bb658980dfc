"""K7 and K8 (the fused binned-min scans) in the torch port against the JAX
package, and the port's plain key table against a numpy oracle.

The JAX side runs ``pallas_binned_scan``/``pallas_binned_scan_select`` in
interpret mode, the port its plain versions on CPU tensors. Rows lie on a
1/4 grid with |x| <= 4, so every f32/bf16 score, and so every packed key,
is exact in both packages; int8 codes and scales come from the JAX
package's quantizer (``convert.searcher_state_from_reference``), and their
dot products are exact int32 sums. Ids must then be equal, d² at rtol 1e-5
and atol 1e-5 * |q|^2. The exact re-score keeps, among rows tied at a
distance, the lower candidate position in the JAX package and the lower id
in the port, so results compare in (distance, id) order and ids tied with
the k-th distance may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu.kernels import binscan as jbs
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu.query.device import _quantize_rows_i8 as j_quantize_rows
from pqvector_tpu_torch import DeviceIvfSearcher
from pqvector_tpu_torch.convert import index_from_reference, searcher_state_from_reference
from pqvector_tpu_torch.kernels import binscan as tbs
from pqvector_tpu_torch.query.device import _quantize_rows_i8

INT32_MAX = 2**31 - 1


def _grid(n, d, seed, b=8):
    rng = np.random.default_rng(seed)
    base = rng.integers(-8, 9, (13, d)).astype(np.float32) / 4.0
    x = base[rng.integers(0, 13, n)] + rng.integers(-2, 3, (n, d)).astype(np.float32) / 4.0
    q = x[rng.integers(0, n, b)] + rng.integers(-1, 2, (b, d)).astype(np.float32) / 4.0
    return x, q


def _pad(x, tile):
    n, d = x.shape
    n_pad = -(-(n + 1) // tile) * tile
    e = np.zeros((n_pad, d), np.float32)
    e[:n] = x
    sq = np.full(n_pad, 3.0e38, np.float32)
    sq[:n] = np.einsum("nd,nd->n", x, x)
    return e, sq


def _operands(x, tile, dtype):
    """(JAX operands, port tensors): emb in the dtype ("int8": the JAX
    package's codes, with its row scale and the f32 rows as re-score)."""
    e, sq = _pad(x, tile)
    ref, scale = None, None
    if dtype == "int8":
        e8, sc = j_quantize_rows(jnp.asarray(e))
        arrays = {"emb": np.asarray(e8), "_emb_i8_scale": np.asarray(sc), "_emb_ref": e}
        ref, scale = e, np.asarray(sc)
    else:
        arrays = {"emb": np.asarray(jnp.asarray(e, getattr(jnp, dtype))), "_emb_ref": None}
    arrays["emb_sq"] = sq
    t = searcher_state_from_reference(arrays, device="cpu")
    j = {"emb": jnp.asarray(arrays["emb"]), "emb_sq": jnp.asarray(sq),
         "scale": None if scale is None else jnp.asarray(scale),
         "emb_ref": None if ref is None else jnp.asarray(ref)}
    return j, t


def _canon(d, i):
    d = np.asarray(d, np.float64)
    i = np.asarray(i).astype(np.int64)
    fin = np.isfinite(d)
    d, i = np.where(fin, d, np.inf), np.where(fin, i, -1)
    order = np.lexsort((i, d), axis=-1)
    return np.take_along_axis(d, order, -1), np.take_along_axis(i, order, -1)


def assert_topk_match(got, want, q, squared=True):
    gd, gi = _canon(*(t.numpy() if isinstance(t, torch.Tensor) else t for t in got))
    wd, wi = _canon(*(np.asarray(t) for t in want))
    if not squared:
        gd, wd = gd ** 2, wd ** 2
    scale = (np.asarray(q, np.float64) ** 2).sum(1).max()
    np.testing.assert_allclose(gd, wd, rtol=1e-5, atol=1e-5 * scale)
    kth = np.where(np.isfinite(wd), wd, -np.inf).max(axis=1, keepdims=True)
    inner = wd < kth - 1e-5 * scale
    np.testing.assert_array_equal(np.where(inner, gi, 0), np.where(inner, wi, 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("expand", [1, 2])
def test_binned_scan_matches_jax(dtype, expand):
    x, q = _grid(3000, 16, seed=expand)
    j, t = _operands(x, 256, dtype)
    want = jbs.pallas_binned_scan(
        jnp.asarray(q), j["emb"], j["emb_sq"], 10, tile=256, expand=expand,
        interpret=True, scale=j["scale"], emb_ref=j["emb_ref"],
    )
    got = tbs.binned_scan(torch.from_numpy(q), t["emb"], t["emb_sq"], 10, tile=256,
                          expand=expand, scale=t.get("_emb_i8_scale"),
                          emb_ref=t["_emb_ref"])
    assert_topk_match(got, want, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("expand", [1, 2])
def test_binned_scan_select_matches_jax(dtype, expand):
    """Fewer slots than tiles, in no order: ids come back global."""
    x, q = _grid(3000, 16, seed=10 + expand)
    j, t = _operands(x, 256, dtype)
    sel = np.array([9, 2, 5, 0, 11], np.int32)  # of 12 tiles; 5 >= expand * 2
    want = jbs.pallas_binned_scan_select(
        jnp.asarray(q), j["emb"], j["emb_sq"], jnp.asarray(sel), 10, tile=256,
        expand=expand, interpret=True, scale=j["scale"], emb_ref=j["emb_ref"],
    )
    got = tbs.binned_scan_select(
        torch.from_numpy(q), t["emb"], t["emb_sq"], torch.from_numpy(sel), 10,
        tile=256, expand=expand, scale=t.get("_emb_i8_scale"), emb_ref=t["_emb_ref"],
    )
    assert_topk_match(got, want, q)
    rows = np.concatenate([np.arange(s * 256, (s + 1) * 256) for s in sel])
    assert set(got[1].numpy().ravel().tolist()) <= set(rows.tolist())


def _oracle_table(q, emb, sq, tiles, tile, expand, scale=None):
    """``_binscan_body``'s table in numpy: slot by slot, each bin set at its
    first touch and min-folded after."""
    n_lg = tile // 128
    n_units = len(tiles)
    tg_bits, g3_bits = jbs.provenance_split(n_units, tile)
    code_bits = tg_bits + g3_bits
    hi_mask = np.int32(~((1 << code_bits) - 1))
    qsq = (q.astype(np.float32) ** 2).sum(1, dtype=np.float32)
    if scale is None:
        qs = (-2.0 * q).astype(np.float32)
    else:
        qa = np.abs(q).max(1)
        tq = np.where(qa > 0, qa * np.float32(1 / 127), np.float32(1.0)).astype(np.float32)
        qs = np.clip(np.round(q / tq[:, None]), -127, 127)
        qt = (np.float32(-2.0) * tq).astype(np.float32)
    table = np.zeros((expand * n_lg, q.shape[0], 128), np.int32)
    touched = np.zeros(expand * n_lg, bool)
    for t, tile_id in enumerate(tiles):
        rows = slice(tile_id * tile, (tile_id + 1) * tile)
        x = emb[rows].astype(np.float64)
        if scale is None:
            scores = (qs.astype(np.float64) @ x.T).astype(np.float32)
            part = (scores + sq[rows][None, :]) + qsq[:, None]
        else:
            dots = (qs @ x.T).astype(np.float32)
            part = (dots * (qt[:, None] * scale[rows][None, :])) + sq[rows][None, :]
            part = np.maximum(part + qsq[:, None], np.float32(0.0))
        part = part.astype(np.float32)
        tg = t // n_lg
        for g3 in range(n_lg):
            keys = (part[:, g3 * 128 : (g3 + 1) * 128].view(np.int32) & hi_mask) | (
                (g3 << tg_bits) + tg
            )
            slab = (t + g3) % n_lg + (tg % expand) * n_lg
            table[slab] = keys if not touched[slab] else np.minimum(table[slab], keys)
            touched[slab] = True
    assert touched.all()
    return table


@pytest.mark.parametrize(
    "tile,expand,dtype,sel",
    [(256, 1, "float32", None), (128, 4, "bfloat16", None), (256, 2, "int8", None),
     (256, 2, "float32", [7, 1, 4, 10]), (128, 1, "int8", [3, 0, 5])],
)
def test_key_table_matches_oracle(tile, expand, dtype, sel):
    """The plain key table, bit for bit: key bits, slab rotation, first
    touch equal to a table started at INT32_MAX."""
    x, q = _grid(2900, 24, seed=tile + expand)
    e, sq = _pad(x, tile)
    qt = torch.from_numpy(q)
    scale = None
    if dtype == "int8":
        e8, sc = _quantize_rows_i8(torch.from_numpy(e))
        emb, scale, emb_np, scale_np = e8, sc, e8.numpy(), sc.numpy()
    else:
        emb = torch.from_numpy(e).to(getattr(torch, dtype))
        emb_np, scale_np = emb.float().numpy(), None
    nt = e.shape[0] // tile
    tiles = list(range(nt)) if sel is None else sel
    want = _oracle_table(q, emb_np, sq, tiles, tile, expand, scale_np)
    if sel is None:
        got = tbs.binned_scan_keys_plain(qt, emb, torch.from_numpy(sq), tile, expand, scale)
    else:
        got = tbs.binned_scan_select_keys_plain(
            qt, emb, torch.from_numpy(sq), torch.tensor(sel, dtype=torch.int32), tile,
            expand, scale,
        )
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != INT32_MAX).all()


def test_quantizers_match_jax():
    """Bit for bit the JAX quantizers as compiled (XLA multiplies by the f32
    reciprocal of 127 where the source divides by it)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((300, 40)) * rng.uniform(0.01, 50, (300, 1))).astype(np.float32)
    x[7] = 0.0  # a zero row gets scale 1 and codes 0
    x[11, :4] = [0.5, -0.5, 1.5, 127.0 / 254]  # halves round to even
    e8, sc = _quantize_rows_i8(torch.from_numpy(x))
    je8, jsc_ = j_quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(e8.numpy(), np.asarray(je8))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(jsc_))
    assert sc[7] == 1.0 and (e8[7] == 0).all()
    qi, tq = tbs.quantize_queries_i8(torch.from_numpy(x))
    jqi, jtq = jax.jit(jbs.quantize_queries_i8)(jnp.asarray(x))
    np.testing.assert_array_equal(qi.numpy(), np.asarray(jqi))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jtq))


@pytest.mark.parametrize("expand,sel", [(1, None), (2, None), (2, [0, 3, 7, 11, 2, 5, 9, 13, 1])])
def test_planted_duplicates_decode(expand, sel):
    """Queries equal to stored rows decode back to those rows: every
    provenance field (tg, g3, slab rotation, lane, the slot's tile)."""
    rng = np.random.default_rng(13)
    n, d, tile = 9000, 32, 512
    emb = (10.0 * rng.standard_normal((n, d))).astype(np.float32)
    e, sq = _pad(emb, tile)
    if sel is None:
        planted = np.arange(7, n, 29)[:96]
        d2, ids = tbs.binned_scan(torch.from_numpy(emb[planted]), torch.from_numpy(e),
                                  torch.from_numpy(sq), 1, tile=tile, expand=expand)
    else:
        rows = np.concatenate([np.arange(t * tile, (t + 1) * tile) for t in sel])
        planted = rows[rows < n][::97][:24]
        d2, ids = tbs.binned_scan_select(
            torch.from_numpy(emb[planted]), torch.from_numpy(e), torch.from_numpy(sq),
            torch.tensor(sel, dtype=torch.int32), 1, tile=tile, expand=expand,
        )
    np.testing.assert_array_equal(ids.numpy()[:, 0], planted)
    assert (d2.numpy()[:, 0] < 1e-3).all()


def test_large_norm_queries():
    """|x|^2 - 2 q.x goes negative when candidates are closer than the
    query's norm, and negative f32 bits compare reversed as ints: the keys
    hold true squared distances (|q|^2 added back)."""
    rng = np.random.default_rng(7)
    n, d, b, k = 3000, 32, 32, 5
    emb = rng.standard_normal((n, d)).astype(np.float32)
    rows = rng.integers(0, n, b)
    q = (emb[rows] + 0.05 * rng.standard_normal((b, d))).astype(np.float32)
    e, sq = _pad(emb, 1024)
    _, ids = tbs.binned_scan(torch.from_numpy(q), torch.from_numpy(e), torch.from_numpy(sq), k)
    ids = ids.numpy()
    truth = np.argsort(((q[:, None] - emb[None]) ** 2).sum(-1), axis=1, kind="stable")[:, :k]
    hits = sum(len(set(a) & set(t)) for a, t in zip(ids.tolist(), truth.tolist()))
    assert hits / (b * k) >= 0.97
    assert (ids[:, 0] == rows).all()


@pytest.mark.parametrize(
    "n_pad,tile,expand,k,sel,match",
    [(128 * 8193, 128, 1, 4, None, "precision"),  # 15 provenance bits
     (1024, 512, 1, 600, None, "bins"),
     (1536, 512, 2, 4, None, "expand"),  # nt = 3 < expand * n_lg = 8
     (9 * 512, 512, 2, 4, [0, 3, 7, 1], "expand")],  # cap 4 < 8
)
def test_guards_raise(n_pad, tile, expand, k, sel, match):
    e = torch.zeros((n_pad, 8 if n_pad < 10**6 else 1), dtype=torch.bfloat16)
    sq = torch.zeros(n_pad)
    q = torch.zeros((4, e.shape[1]))
    with pytest.raises(ValueError, match=match):
        if sel is None:
            tbs.binned_scan(q, e, sq, k, tile=tile, expand=expand)
        else:
            tbs.binned_scan_select(q, e, sq, torch.tensor(sel, dtype=torch.int32), k,
                                   tile=tile, expand=expand)


def _searchers(n, d, kc, seed, row_tile, sorted_, modes_scale=None):
    """The JAX searcher and the port's, on one index and one set of rows."""
    rng = np.random.default_rng(seed)
    if modes_scale is None:
        x, q = _grid(n, d, seed, b=16)
    else:
        modes = rng.uniform(-1, 1, (kc, d)).astype(np.float32)
        x = (modes[rng.integers(0, kc, n)] + 0.1 * rng.standard_normal((n, d))).astype(np.float32)
        rows = rng.integers(0, n, 32)
        q = (x[rows] + 0.03 * rng.standard_normal((32, d))).astype(np.float32)
    index = j_build_ivf_index(JEmbeddings(x, d), JIvfBuildConfig(n_clusters=kc, seed=0))
    js = JSearcher(index, x, row_tile=row_tile, cluster_sorted=sorted_)
    tindex = index_from_reference(np.asarray(index.centroids), index.list_offsets,
                                  index.row_ids)
    ts = DeviceIvfSearcher(tindex, x, row_tile=row_tile, cluster_sorted=sorted_,
                           device="cpu")
    return js, ts, q


@pytest.mark.parametrize("sorted_", [False, True])
def test_searcher_binscan_modes_match_jax(sorted_):
    js, ts, q = _searchers(3000, 32, 8, 4, 128, sorted_)
    assert ts.can_binscan(5) == js.can_binscan(5)
    assert ts.can_binscan(5, esize=1) == js.can_binscan(5, esize=1)
    for mode in ("binscan", "binscan8"):
        want = js.exact(q, 5, mode=mode)
        assert_topk_match(ts.exact(q, 5, mode), want, q, squared=False)
        assert_topk_match(ts.search(q, 5, 4, mode), want, q, squared=False)


def test_searcher_bincompact_modes_match_jax():
    js, ts, q = _searchers(4000, 32, 16, 6, 512, True, modes_scale=1)
    assert ts._compact_bin_params(32, 4, 5) == js._compact_bin_params(32, 4, 5)
    assert ts._compact_bin_params(32, 4, 5, esize=1) == js._compact_bin_params(32, 4, 5, esize=1)
    for mode in ("bincompact", "bincompact8"):
        want = js.search(q, 5, nprobe=4, mode=mode)
        assert_topk_match(ts.search(q, 5, 4, mode), want, q, squared=False)


def test_compact_select_both_branches_match_jax():
    """Tile ranges (sorted layout) and row_cluster (file order) pick the
    same tiles, in the same order, as the JAX package's selection."""
    from pqvector_tpu.query.device import _compact_select as j_select

    from pqvector_tpu_torch.query.device import _compact_select as t_select

    for sorted_ in (True, False):
        js, ts, q = _searchers(4000, 32, 16, 6, 512, sorted_, modes_scale=1)
        ctile, n_pad = 512, int(ts.emb.shape[0])
        nt = n_pad // ctile
        jlo, jhi, jspan = js._compact_tile_ranges(ctile)
        tlo, thi, tspan = ts._compact_tile_ranges(ctile)
        assert jspan == tspan
        for nprobe, cap in ((2, 3), (4, nt)):
            want = j_select(jnp.asarray(q), js.centroids, js.c_sq, js.row_cluster,
                            jnp.int32(nprobe), 8, ctile, cap, jlo, jhi, jspan, n_pad)
            got = t_select(torch.from_numpy(q), ts.centroids, ts.c_sq, ts.row_cluster,
                           nprobe, ctile, cap, tlo, thi, tspan, n_pad)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_geometry_rules_match_jax():
    js, ts, q = _searchers(1 << 14, 128, 16, 11, 2048, True)
    for esize in (None, 1):
        t = ts._binscan_tile(esize=esize)
        assert t == js._binscan_tile(esize=esize)
        assert ts._binscan_expand(t, esize=esize) == js._binscan_expand(t, esize=esize)
        assert ts._binscan_expand(t, cap=3, esize=esize) == js._binscan_expand(
            t, cap=3, esize=esize)
        assert tbs.binscan_b_tile(t, 128, esize or 4, ts._binscan_expand(t, esize=esize)) >= 256
    for tile, d, esize, expand in ((2048, 128, 2, 1), (2048, 128, 2, 2), (2048, 128, 2, 4),
                                   (2048, 1024, 4, 1), (1024, 1024, 4, 1), (2048, 96, 1, 2)):
        assert tbs.binscan_b_tile(tile, d, esize, expand) == jbs.binscan_b_tile(
            tile, d, esize, expand)
    for n_tiles, tile in ((490, 2048), (4884, 2048), (1, 128), (8193, 128)):
        assert tbs.provenance_split(n_tiles, tile) == jbs.provenance_split(n_tiles, tile)
    assert tbs.provenance_bits(4884, 2048) == tbs.PROVENANCE_BITS_MAX


def test_calibrate_bincompact_matches_jax_and_is_scoped():
    js, ts, _ = _searchers(24000, 16, 24, 10, 512, True, modes_scale=1)
    rng = np.random.default_rng(1)
    cent = np.asarray(js.index.centroids)
    q = (cent[0][None, :] + 0.05 * rng.standard_normal((8, 16))).astype(np.float32)
    for bucket in (1, 128):
        got = ts.calibrate_bincompact(q, nprobe=2, k=5, bucket=bucket)
        assert got == js.calibrate_bincompact(q, nprobe=2, k=5, bucket=bucket)
        assert ts._bincompact_calibrated == js._bincompact_calibrated
    ctile, cap = ts.calibrate_bincompact(q, nprobe=2, k=5, bucket=1)
    js.calibrate_bincompact(q, nprobe=2, k=5, bucket=1)
    assert 1 <= cap < int(ts.emb.shape[0]) // ctile
    # within the operating point the measured cap drives the mode ...
    assert ts._compact_bin_params(8, 2, 5) == (ctile, cap)
    # ... beyond it (more probes, a bigger batch) the formula, as in JAX
    for batch, nprobe in ((8, 16), (4096, 2), (4096, 16)):
        assert ts._compact_bin_params(batch, nprobe, 5) == js._compact_bin_params(
            batch, nprobe, 5)
    assert ts.bincompact_coverage(8, 2, 5) == js.bincompact_coverage(8, 2, 5)
    ts._bincompact_calibrated = None
    js._bincompact_calibrated = None
    assert ts._compact_bin_params(8, 2, 5) == js._compact_bin_params(8, 2, 5) != (0, 0)
    _, unsorted, q_u = _searchers(3000, 32, 8, 4, 128, False)
    assert unsorted.calibrate_bincompact(q_u, 2) == (0, 0)  # file order: ineligible


def test_convert_carries_int8_state():
    x, _ = _grid(500, 16, seed=2)
    js = JSearcher(j_build_ivf_index(JEmbeddings(x, 16), JIvfBuildConfig(n_clusters=4)),
                   x, row_tile=128)
    e8, sc = js._xbin8_arrays()
    t = searcher_state_from_reference(
        {"_emb_i8": np.asarray(e8), "_emb_i8_scale": np.asarray(sc),
         "row_cluster": np.asarray(js.row_cluster)},
        device="cpu",
    )
    assert t["_emb_i8"].dtype == torch.int8 and t["_emb_i8_scale"].dtype == torch.float32
    assert t["row_cluster"].dtype == torch.int32
    ts = DeviceIvfSearcher(index_from_reference(np.asarray(js.index.centroids),
                                                js.index.list_offsets, js.index.row_ids),
                           x, row_tile=128, device="cpu")
    pe8, psc = ts._xbin8_arrays()
    assert torch.equal(pe8, t["_emb_i8"]) and torch.equal(psc, t["_emb_i8_scale"])
    assert torch.equal(ts.row_cluster, t["row_cluster"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("select", [False, True])
def test_kernel_matches_plain_on_card(cuda_device, dtype, select):
    x, q = _grid(40_000, 72, seed=5, b=37)
    _, t = _operands(x, 512, dtype)
    emb, sq = t["emb"].to(cuda_device), t["emb_sq"].to(cuda_device)
    scale = t.get("_emb_i8_scale")
    scale = None if scale is None else scale.to(cuda_device)
    qt = torch.from_numpy(q).to(cuda_device)
    if select:
        sel = torch.tensor([70, 3, 41, 9, 0, 77, 12, 55, 20], dtype=torch.int32,
                           device=cuda_device)
        args = (qt, emb, sq, sel, 512, 2, scale)
        got = tbs.binned_scan_select_keys(*args)
        want = tbs.binned_scan_select_keys_plain(*args)
    else:
        args = (qt, emb, sq, 512, 2, scale)
        got, want = tbs.binned_scan_keys(*args), tbs.binned_scan_keys_plain(*args)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
