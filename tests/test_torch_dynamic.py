"""Dynamic updates of the port's resident searcher (``delete_rows``,
``append_rows`` and the ``_finalize`` epilogue) against the JAX package on
the CPU: tombstone deletes and the delta-buffer append (main + memtable).

Twins of ``tests/test_dynamic.py``, the SQL resident step-aside included.

Tolerance: ids equal; rows may swap only where their distances tie within
1e-5. Distances of main-layout rows within rtol 1e-5 / atol 1e-5. A delta
row's distance comes, in both packages, from the expanded form
``|x|^2 - 2 q.x + |q|^2`` summed in different orders, which cancels for a
row next to its query: its squared distance is held within 1e-5 |q|^2.
"""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import pqvector_tpu
from pqvector_tpu import Embeddings as JEmbeddings
from pqvector_tpu import IvfBuildConfig as JIvfBuildConfig
from pqvector_tpu import build_ivf_index as j_build_ivf_index
from pqvector_tpu.engine.session import Session as JSession
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch import DeviceIvfSearcher, ValidationError
from pqvector_tpu_torch.convert import index_from_reference
from pqvector_tpu_torch.engine.session import Session


@pytest.fixture()
def setup():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((600, 12)).astype(np.float32)
    jindex = j_build_ivf_index(JEmbeddings(x, 12), JIvfBuildConfig(n_clusters=8, seed=0))
    index = index_from_reference(np.asarray(jindex.centroids), jindex.list_offsets,
                                 jindex.row_ids)
    q = (x[[7, 40, 300]] + 0.01).astype(np.float32)
    return x, jindex, index, q


def _pair(setup, spill=0.0, dtype="float32", **kw):
    x, jindex, index, _ = setup
    jkw = dict(kw, dtype=getattr(jnp, dtype))
    tkw = dict(kw, dtype=getattr(torch, dtype), device="cpu")
    if spill:
        return (JSearcher.with_spill(jindex, x, spill=spill, **jkw),
                DeviceIvfSearcher.with_spill(index, x, spill=spill, **tkw))
    return JSearcher(jindex, x, **jkw), DeviceIvfSearcher(index, x, **tkw)


def _rows(x, extra):
    return x if extra is None else np.vstack([x, extra])


def _assert_same(got, want, rows, q):
    gd, gi = (t.numpy() for t in got)
    wd, wi = np.asarray(want[0]), np.asarray(want[1])
    assert np.array_equal(np.isinf(gd), np.isinf(wd))
    ok = np.isfinite(wd)
    qq = np.broadcast_to((q * q).sum(1)[:, None], wd.shape)
    assert np.all(np.abs(gd[ok] ** 2 - wd[ok] ** 2)
                  <= 1e-5 * qq[ok] + 1e-5 * wd[ok] ** 2 + 1e-5)
    for b, c in zip(*np.nonzero(gi != wi)):
        assert gi[b, c] >= 0 and wi[b, c] >= 0
        d_g = ((rows[gi[b, c]] - q[b]) ** 2).sum()
        d_w = ((rows[wi[b, c]] - q[b]) ** 2).sum()
        assert abs(d_g - d_w) <= 1e-5 * max(d_w, qq[b, 0]), (b, c)


def _truth(x, q, k, alive=None, extra=None, extra_ids=None):
    rows = _rows(x, extra)
    ids = np.arange(len(x)) if extra is None else np.concatenate([np.arange(len(x)), extra_ids])
    d2 = np.sum(q * q, 1)[:, None] - 2.0 * q @ rows.T + np.sum(rows * rows, 1)[None, :]
    if alive is not None:
        d2[:, ~alive] = np.inf
    return ids[np.argsort(d2, axis=1, kind="stable")[:, :k]]


def test_delete_rows_excluded_everywhere(setup):
    x, _, _, q = setup
    js, ts = _pair(setup)
    k = 5
    victims = ts.exact(q, k)[1].numpy()[:, 0]  # every query's nearest
    js.delete_rows(victims)
    ts.delete_rows(victims)
    alive = np.ones(len(x), bool)
    alive[victims] = False
    want = _truth(x, q, k, alive=alive)
    for call in (
        lambda s: s.exact(q, k),
        lambda s: s.search(q, k, 8, mode="masked"),
        lambda s: s.search(q, k, 8, mode="gather"),
        lambda s: s.search_loop(q, k, 8, reps=2, mode="masked"),
        lambda s: s.exact_loop(q, k, reps=2, mode="xla"),
    ):
        got = call(ts)
        assert not np.isin(got[1].numpy(), victims).any()
        np.testing.assert_array_equal(got[1].numpy(), want)
        _assert_same(got, call(js), x, q)


def test_delete_validation(setup):
    _, ts = _pair(setup)
    x = setup[0]
    with pytest.raises(ValidationError, match="delete_rows ids"):
        ts.delete_rows([len(x) + 5])
    with pytest.raises(ValidationError, match="delete_rows ids"):
        ts.delete_rows([-1])
    ts.delete_rows([])  # no-op
    assert ts._deleted_dev is None and ts._plain()


def test_append_rows_found_exactly(setup):
    x, _, _, q = setup
    js, ts = _pair(setup)
    rng = np.random.default_rng(9)
    new = (q + 0.001 * rng.standard_normal(q.shape)).astype(np.float32)
    new_ids = ts.append_rows(new)
    np.testing.assert_array_equal(new_ids, js.append_rows(new))
    np.testing.assert_array_equal(new_ids, len(x) + np.arange(3))
    rows = _rows(x, new)
    got = ts.exact(q, 4)
    np.testing.assert_array_equal(got[1].numpy()[:, 0], new_ids)
    _assert_same(got, js.exact(q, 4), rows, q)
    assert np.all(np.diff(got[0].numpy(), axis=1) >= -1e-6)
    gm = ts.search(q, 4, 8, mode="masked")
    np.testing.assert_array_equal(gm[1].numpy()[:, 0], new_ids)
    _assert_same(gm, js.search(q, 4, 8, mode="masked"), rows, q)
    more = rng.standard_normal((2, 12)).astype(np.float32)
    np.testing.assert_array_equal(ts.append_rows(more), len(x) + 3 + np.arange(2))
    js.append_rows(more)
    g2 = ts.exact(q, 4)
    np.testing.assert_array_equal(g2[1].numpy()[:, 0], new_ids)
    _assert_same(g2, js.exact(q, 4), _rows(rows, more), q)


def test_update_row_delete_then_append(setup):
    x, _, _, q = setup
    js, ts = _pair(setup)
    old = int(ts.exact(q[:1], 1)[1].numpy()[0, 0])
    for s in (js, ts):
        s.delete_rows([old])
    new_id = int(ts.append_rows(x[old] * 1.0)[0])
    js.append_rows(x[old] * 1.0)
    got = ts.exact(q[:1], 2)
    assert got[1].numpy()[0, 0] == new_id and old not in got[1].numpy()[0].tolist()
    _assert_same(got, js.exact(q[:1], 2), _rows(x, x[old][None]), q[:1])
    for s in (js, ts):
        s.delete_rows([new_id])  # tombstones it in the delta buffer
    got2 = ts.exact(q[:1], 2)
    assert new_id not in got2[1].numpy()[0].tolist()
    _assert_same(got2, js.exact(q[:1], 2), _rows(x, x[old][None]), q[:1])


def test_dynamic_on_spilled_searcher(setup):
    x, _, _, q = setup
    js, ts = _pair(setup, spill=0.3)
    assert ts._id_domain == js._id_domain == len(x)
    victim = int(ts.exact(q, 3)[1].numpy()[0, 0])
    for s in (js, ts):
        s.delete_rows([victim])  # both copies tombstoned
    new_ids = ts.append_rows(q[:1])
    js.append_rows(q[:1])
    got = ts.exact(q, 3)
    ids = got[1].numpy()
    assert victim not in ids[0].tolist() and ids[0, 0] == new_ids[0]
    for r in ids:
        vals = [v for v in r.tolist() if v >= 0]
        assert len(set(vals)) == len(vals)
    _assert_same(got, js.exact(q, 3), _rows(x, q[:1]), q)


@pytest.mark.parametrize("mode", ["approx", "scan", "binscan", "binscan8"])
def test_scan_modes_respect_dynamic_state(setup, mode):
    """The nprobe-free serving modes also exclude tombstones and merge
    deltas: the filter and merge live in the shared finalize, not per mode
    (the JAX test's ``xbin``/``xbin8`` are not ported; the port's full
    scans stand in)."""
    x, _, _, q = setup
    js, ts = _pair(setup, row_tile=128)
    victim = int(ts.exact(q, 3)[1].numpy()[0, 0])
    for s in (js, ts):
        s.delete_rows([victim])
    new_ids = ts.append_rows(q[:1] + 0.0005)
    js.append_rows(q[:1] + 0.0005)
    got = ts.search(q, 3, 1, mode=mode)
    assert victim not in got[1].numpy()[0].tolist()
    assert got[1].numpy()[0, 0] == new_ids[0]
    _assert_same(got, js.search(q, 3, 1, mode=mode), _rows(x, q[:1] + 0.0005), q)


def test_delta_bucket_shapes_stable(setup):
    """Delta capacity grows in power-of-two buckets (floor 256): repeated
    small appends keep the finalize's shapes stable."""
    x, _, _, q = setup
    rng = np.random.default_rng(2)
    _, ts = _pair(setup)
    shapes = set()
    for _ in range(5):
        ts.append_rows(rng.standard_normal((3, 12)).astype(np.float32))
        shapes.add(tuple(ts._delta[0].shape))
    assert shapes == {(256, 12)}
    ts.delete_rows([int(ts._id_domain - 1)])
    assert int(ts._deleted_dev.shape[0]) >= ts._id_domain
    assert int(ts._id_domain - 1) not in ts.exact(q, 3)[1].numpy().tolist()


def test_append_then_delete_bitmap_covers_domain(setup):
    """Deleting BEFORE appending leaves no small bitmap that appended ids
    clip-alias into."""
    x, _, _, q = setup
    js, ts = _pair(setup)
    for s in (js, ts):
        s.delete_rows([0])
    new_ids = ts.append_rows(q[:1])
    js.append_rows(q[:1])
    assert int(ts._deleted_dev.shape[0]) >= ts._id_domain
    got = ts.exact(q, 2)
    assert got[1].numpy()[0, 0] == new_ids[0]
    _assert_same(got, js.exact(q, 2), _rows(x, q[:1]), q)


def test_sql_resident_steps_aside_for_dynamic_state(tmp_path):
    """SQL serves FILE contents: a resident searcher holding dynamic state
    is skipped, the host path answers, and the file's own row wins over the
    appended copy (appended ids are no file rows)."""
    rng = np.random.default_rng(6)
    n, d = 300, 8
    x = rng.standard_normal((n, d)).astype(np.float32)
    flat = pa.array(x.reshape(-1), pa.float32())
    offsets = pa.array(np.arange(n + 1, dtype=np.int32) * d)
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"id": pa.array(np.arange(n)),
                             "vec": pa.ListArray.from_arrays(offsets, flat)}),
                   path, row_group_size=64)
    pqvector_tpu.IndexBuilder(path, "vec").n_clusters(6).build_inplace()

    s = Session(device="cpu")
    s.register_parquet("t", path)
    s.device_searcher("t").append_rows(x[:1] + 0.0001)
    q = ", ".join(f"{v:.6f}" for v in x[0])
    sql = f"SELECT id FROM t ORDER BY array_distance(vec, [{q}]) LIMIT 3"
    ids = s.sql(sql).collect().column("id").to_pylist()
    assert len(ids) == 3 and all(0 <= i < n for i in ids)
    assert ids[0] == 0
    js = JSession()
    js.register_parquet("t", path)
    js.device_searcher("t").append_rows(x[:1] + 0.0001)
    assert ids == js.sql(sql).collect().column("id").to_pylist()


def test_int8_scan_modes_respect_dynamic_state(setup):
    """binscan8's int8 codes of the static layout are stale by design
    (quantized at residency): deletes drop rows at finalize and appended
    rows surface from the delta buffer."""
    x, _, _, q = setup
    js, ts = _pair(setup, cluster_sorted=True, row_tile=128)
    victim = int(ts.search(q, 3, 1, mode="binscan8")[1].numpy()[0, 0])
    for s in (js, ts):
        s.delete_rows([victim])
    got = ts.search(q, 3, 1, mode="binscan8")
    assert victim not in got[1].numpy()[0].tolist()
    _assert_same(got, js.search(q, 3, 1, mode="binscan8"), x, q)
    new_row = q[0:1] * 1.0001
    ts.append_rows(new_row)
    js.append_rows(new_row)
    got2 = ts.search(q, 3, 1, mode="binscan8")
    assert got2[1].numpy()[0, 0] == ts._id_domain - 1
    _assert_same(got2, js.search(q, 3, 1, mode="binscan8"), _rows(x, new_row), q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["auto", "stream", "pallas", "gather", "bincompact",
                                  "compact", "cert"])
def test_sorted_searcher_modes_after_updates_match_jax(setup, dtype, mode):
    """Every served mode of a cluster-sorted searcher after deletes and
    appends: the K2-K8 paths read the norms through the kernels' finite
    copy, which a delete must rebuild (a stale copy would let a deleted row
    take a slot that the finalize then empties)."""
    x, _, _, q = setup
    js, ts = _pair(setup, dtype=dtype, cluster_sorted=True, row_tile=512)
    ts._pallas_emb_sq()  # build the lazy copy before the delete
    victims = _truth(x, q, 6)[:, :4].reshape(-1)
    for s in (js, ts):
        s.delete_rows(victims)
    extra = (q + 0.002).astype(np.float32)
    ts.append_rows(extra)
    js.append_rows(extra)
    got = ts.search(q, 5, 8, mode=mode)
    jmode = "gather" if mode == "auto" else mode
    _assert_same(got, js.search(q, 5, 8, mode=jmode), _rows(x, extra), q)
    ids = got[1].numpy()
    assert not np.isin(ids, victims).any() and (ids >= 0).all()
    np.testing.assert_array_equal(ids[:, 0], len(x) + np.arange(len(q)))
    if mode in ("stream", "pallas", "cert"):
        egot = ts.exact(q, 5, mode=mode)
        _assert_same(egot, js.exact(q, 5, mode=mode), _rows(x, extra), q)
