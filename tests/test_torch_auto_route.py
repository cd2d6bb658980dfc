"""``search(mode="auto")`` on cluster-sorted layouts takes K3 (``stream``) at
every batch size, on the CPU: small grid layouts at d = 64 and 1024, k = 10
and 100, B = 1, 8 and 256, bf16 storage with the f32 re-score copy (the
benchmark's cells). ``auto`` must give what K4's route (``pallas``) gives,
bit for bit, and what the JAX package's ``search`` gives under the tie rules
of ``test_torch_slice.py``. The rows lie on a 1/4 grid with |x| <= 2.5 (the
queries |q| <= 2.75), so bf16 stores them exactly and every f32 score is
exact at d = 1024 (|q.x| <= 7,040 in steps of 1/16 needs 17 bits): the two
routes can only differ by a fault, and the packages only where ids tie at
the k-th distance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pqvector_tpu_torch.query.device as device_mod
from pqvector_tpu import IvfIndex as JIvfIndex
from pqvector_tpu.query.device import DeviceIvfSearcher as JSearcher
from pqvector_tpu_torch import DeviceIvfSearcher, IvfIndex

N, KC, NPROBE, TILE = 3000, 12, 3, 256


def _grid(d: int, seed: int):
    rng = np.random.default_rng(seed)
    cent = rng.integers(-8, 9, (KC, d)).astype(np.float32) / 4
    assign = rng.integers(0, KC, N)
    x = cent[assign] + rng.integers(-2, 3, (N, d)).astype(np.float32) / 4
    q = x[rng.integers(0, N, 256)] + rng.integers(-1, 2, (256, d)).astype(np.float32) / 4
    return x, q, cent, assign


@pytest.fixture(scope="module", params=[64, 1024])
def layout(request):
    d = request.param
    x, q, cent, assign = _grid(d, seed=d)
    ts = DeviceIvfSearcher(IvfIndex.from_assignments(cent, assign), x, dtype=torch.bfloat16,
                           row_tile=TILE, cluster_sorted=True, device="cpu")
    js = JSearcher(JIvfIndex.from_assignments(cent, assign), x, dtype=jnp.bfloat16,
                   row_tile=TILE, cluster_sorted=True)
    assert ts._ref() is not None
    return ts, js, q


def _canon(d, i):
    d = np.asarray(d, np.float64)
    i = np.asarray(i).astype(np.int64)
    d = np.where(i >= 0, d, np.inf)
    i = np.where(np.isfinite(d), i, -1)
    order = np.lexsort((i, d), axis=-1)
    return np.take_along_axis(d, order, -1), np.take_along_axis(i, order, -1)


def assert_match(got, want, q):
    """Distances at rtol 1e-5 (d² against 1e-5 |q|²); ids equal below the
    k-th distance, where ties may pick other rows."""
    gd, gi = _canon(*(t.numpy() for t in got))
    wd, wi = _canon(*(np.asarray(t) for t in want))
    scale = float((q.astype(np.float64) ** 2).sum(1).max())
    np.testing.assert_allclose(gd ** 2, wd ** 2, rtol=1e-5, atol=1e-5 * scale)
    kth = np.where(np.isfinite(wd), wd, -np.inf).max(axis=1, keepdims=True)
    inner = wd ** 2 < kth ** 2 - 1e-5 * scale
    np.testing.assert_array_equal(np.where(inner, gi, 0), np.where(inner, wi, 0))


def _routes(monkeypatch):
    """Record which of K4's and K3's wrappers each search call reaches."""
    taken = []
    for name, route in (("masked_local_topk", "K4"), ("stream_masked_topk", "K3")):
        run = getattr(device_mod, name)

        def spy(*args, _run=run, _route=route, **kwargs):
            taken.append(_route)
            return _run(*args, **kwargs)

        monkeypatch.setattr(device_mod, name, spy)
    return taken


@pytest.mark.parametrize("batch", [1, 8, 256])
@pytest.mark.parametrize("k", [10, 100])
def test_auto_takes_k3_and_equals_k4s_route(layout, monkeypatch, k, batch):
    ts, _, q = layout
    taken = _routes(monkeypatch)
    d_a, i_a = ts.search(q[:batch], k, NPROBE, mode="auto")
    d_p, i_p = ts.search(q[:batch], k, NPROBE, mode="pallas")
    assert taken == ["K3", "K4"]
    assert torch.equal(i_a, i_p)
    torch.testing.assert_close(d_a, d_p, rtol=0, atol=0)


@pytest.mark.parametrize("batch", [1, 8, 256])
@pytest.mark.parametrize("k", [10, 100])
def test_auto_equals_the_jax_search(layout, k, batch):
    ts, js, q = layout
    qb = q[:batch]
    assert_match(ts.search(qb, k, NPROBE, mode="auto"), js.search(qb, k, NPROBE), qb)
