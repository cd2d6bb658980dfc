"""``search(mode="auto")`` on a DEEP10M-shaped deployment, scaled down for
the CPU: 96-d rows of a seeded mixture (64 modes, 4 clusters a mode as in
the 10M x 96, IVF-4096 one of 1024 modes), bf16 storage with the f32
re-score copy, rows sorted by cluster. Both routes on that layout, K3
(``auto``) and K4 (``pallas``), are held to the benchmark's plain reference
(``pqbench.reference``) through the numbers that decide a cell's
``correct``; the reference one precision step down (the control) fails
them. And the route rules at the cell's own geometry: ``auto`` takes K3 at
every batch; ``pallas`` takes K4 on 9,766 tiles of 1024 rows while the local
mask fits (B = 256), K6 beyond (B = 4096)."""

import pytest
import torch

import pqvector_tpu_torch.query.device as device_mod
from pqbench import gen
from pqbench.reference import kmeans
from pqbench.reference.compare import search_numbers
from pqbench.reference.control import ControlSearcher
from pqbench.reference.exact import Layout
from pqvector_tpu_torch import DeviceIvfSearcher, IvfIndex

ROWS, DIM, MODES, CLUSTERS = 40_000, 96, 64, 256
K, NPROBE, BATCH = 10, 4, 64
#: ``dist_err``: the returned distance against the f64 distance of the
#: returned row, over the k-th probed distance. The program re-scores in f32
#: (1e-7 here); the control's TF32 re-score reads 3e-4.
DIST_TOL = 1e-5
#: ``select_gap``: the returned rows against the exact top-k of the probed
#: clusters, slot by slot, over the same distance. The program selects on
#: bf16 rows (0.006 here, seeds 1-3); the control's fp8 selection reads
#: 0.027-0.031.
GAP_TOL = 0.015
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def deployment():
    seed = 20_260_418_123  # larger than 32 bits, as the benchmark's seeds are
    modes = gen.mixture_modes(seed, {"modes": MODES}, DIM, CPU)
    rows = gen.mixture_rows(modes, ROWS, 0.15, seed, "rows")
    cents, assign = kmeans.train(rows, CLUSTERS, 20, 42)
    index = IvfIndex.from_assignments(cents.numpy(), assign.numpy())
    searcher = DeviceIvfSearcher(index, rows.numpy(), dtype=torch.bfloat16, metric="l2",
                                 cluster_sorted=True, rescore_dtype="auto", device=CPU)
    queries = gen.mixture_rows(modes, BATCH, 0.15, seed, "queries")
    return searcher, Layout(rows, assign, cents), queries


def _numbers(layout, q, d, ids):
    numbers, _, _, _ = search_numbers(layout, q, torch.as_tensor(d).float(),
                                      torch.as_tensor(ids), K, NPROBE)
    return numbers


def _routes(monkeypatch):
    """Record which of K4's and K3's paths each search call takes."""
    taken = []
    for name, route in (("masked_local_topk", "K4"), ("stream_masked_topk", "K3")):
        run = getattr(device_mod, name)

        def spy(*args, _run=run, _route=route, **kwargs):
            taken.append(_route)
            return _run(*args, **kwargs)

        monkeypatch.setattr(device_mod, name, spy)
    return taken


@pytest.mark.parametrize("route", ["K4", "K3"])
def test_auto_meets_the_reference_on_a_deep_shaped_layout(deployment, monkeypatch, route):
    """K3 is ``auto``'s route on the sorted layout; K4 stays under
    ``pallas`` (its local mask is ~0.2 MB at 40k rows)."""
    searcher, layout, q = deployment
    taken = _routes(monkeypatch)
    mode = "auto" if route == "K3" else "pallas"
    d, ids = searcher.search(q.numpy(), K, NPROBE, mode=mode)
    assert taken == [route]
    numbers = _numbers(layout, q, d, ids)
    assert numbers["dist_err"] <= DIST_TOL, numbers
    assert numbers["select_gap"] <= GAP_TOL, numbers


def test_the_control_fails_the_tolerances(deployment):
    _, layout, q = deployment
    d, ids = ControlSearcher(layout).search(q, K, NPROBE)
    numbers = _numbers(layout, q, d, ids)
    assert numbers["dist_err"] > DIST_TOL or numbers["select_gap"] > GAP_TOL, numbers


def _cell_geometry(cmax: int) -> DeviceIvfSearcher:
    """A searcher shell with the deployment's layout sizes and no rows:
    10M rows padded to 2048-row blocks, sorted by cluster, ``cmax``
    clusters in its fullest 1024-row tile."""
    s = DeviceIvfSearcher.__new__(DeviceIvfSearcher)
    s.row_tile = 2048
    s.emb = torch.empty((device_mod._round_up(10_000_000 + 1, s.row_tile), 0))  # + the sentinel
    s._row_cluster_sorted = True
    s._tile_tables = {}
    s._cmax_cache = {1024: cmax}
    return s


def test_scan_tile_and_tiles_at_the_cell_size():
    s = _cell_geometry(2)
    assert s._scan_tile() == 1024
    assert s.emb.shape[0] // s._scan_tile() == 9766


@pytest.mark.parametrize("batch,cmax,route", [
    (4096, 1, "K4"),  # 160 MB: one cluster a tile would still fit
    (4096, 2, "K3"),  # 320 MB
    (4096, 3, "K3"),
    (4096, 26, "K3"),
    (256, 1, "K4"),
    (256, 2, "K4"),
    (256, 26, "K4"),  # 260 MB
    (256, 27, "K3"),  # 270 MB
])
def test_the_route_rule_at_the_cell_geometry(batch, cmax, route):
    """The rules on the deployment's layout: ``auto`` takes K3 (``stream``)
    at every batch and k <= 128, ``gather`` beyond; ``pallas`` takes K4
    while the [nt, B, cmax] f32 local mask stays within
    ``_LOCAL_MASK_CAP``. ``route`` is K4 where the mask fits and K3 where it
    does not: there ``pallas`` takes K6, and ``auto`` K3 as everywhere."""
    s = _cell_geometry(cmax)
    assert s._auto_mode(K, NPROBE, batch) == "stream"
    assert s._auto_mode(100, NPROBE, batch) == "stream"
    assert s._auto_mode(device_mod.MAX_K + 1, NPROBE, batch) == "gather"
    want_k4 = 9766 * batch * cmax * 4 <= 256 << 20
    assert want_k4 == (route == "K4")
    assert s._use_local_mask(1024, batch) is want_k4
