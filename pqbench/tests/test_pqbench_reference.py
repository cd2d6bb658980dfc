"""The plain reference against NumPy at a small size."""

import struct

import numpy as np
import pytest
import torch

from pqbench import gen
from pqbench.reference import kmeans, payload
from pqbench.reference.control import fp8, tf32
from pqbench.reference.exact import Layout, exact_topk, topk_in_clusters


@pytest.fixture(scope="module")
def data():
    modes = gen.mixture_modes(5, {"modes": 6}, 12, "cpu")
    rows = gen.mixture_rows(modes, 3000, 0.15, 5, "rows")
    q = gen.mixture_rows(modes, 40, 0.15, 5, "queries")
    cents, assign = kmeans.train(rows, 20, 6, 42)
    return rows, q, cents, assign, Layout(rows, assign, cents)


def numpy_topk(x, q, k, allowed=None):
    d2 = ((x[None, :, :].astype(np.float64) - q[:, None, :]) ** 2).sum(-1)
    if allowed is not None:
        d2 = np.where(allowed, d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d2, idx, 1), idx


def test_pqbench_exact_topk_matches_numpy(data):
    rows, q, cents, assign, lay = data
    probe, _ = lay.probe(q, 3)
    d2, pos = exact_topk(lay, q, 7, probe)
    want_d2, want_ids = numpy_topk(rows.numpy(), q.numpy(), 7)
    np.testing.assert_array_equal(lay.order[pos].numpy(), want_ids)
    np.testing.assert_allclose(d2.numpy(), want_d2, rtol=1e-12)


def test_pqbench_probed_topk_matches_numpy(data):
    rows, q, cents, assign, lay = data
    probe, _ = lay.probe(q, 3)
    cd2 = ((q.numpy()[:, None, :].astype(np.float64) - cents.numpy()[None]) ** 2).sum(-1)
    want_probe = np.argsort(cd2, axis=1, kind="stable")[:, :3]
    np.testing.assert_array_equal(probe.numpy(), want_probe)
    allowed = (assign.numpy()[None, None, :] == want_probe[:, :, None]).any(axis=1)
    d2, pos = topk_in_clusters(lay, q, probe, 5)
    want_d2, want_ids = numpy_topk(rows.numpy(), q.numpy(), 5, allowed)
    np.testing.assert_array_equal(lay.order[pos].numpy(), want_ids)
    np.testing.assert_allclose(d2.numpy(), want_d2, rtol=1e-12)


def test_pqbench_radii_bound_every_row(data):
    rows, _, cents, assign, lay = data
    dist = np.linalg.norm(rows.numpy().astype(np.float64) - cents.numpy()[assign.numpy()], axis=1)
    radii = np.zeros(cents.shape[0])
    np.maximum.at(radii, assign.numpy(), dist)
    np.testing.assert_allclose(lay.radii.numpy(), radii, rtol=1e-12)


def test_pqbench_kmeans_assigns_nearest_and_repeats(data):
    rows, _, cents, assign, _ = data
    d2 = ((rows.numpy()[:, None, :].astype(np.float64) - cents.numpy()[None]) ** 2).sum(-1)
    best = d2.min(axis=1)
    mine = d2[np.arange(len(d2)), assign.numpy()]
    assert ((mine - best) / best.max()).max() < 1e-6
    again, a2 = kmeans.train(rows, 20, 6, 42)
    assert torch.equal(again, cents) and torch.equal(a2, assign)


def test_pqbench_generator_repeats_by_seed():
    a = gen.mixture_rows(gen.mixture_modes(2**31 + 11, {"modes": 4}, 8, "cpu"), 50, 0.15,
                         2**31 + 11, "rows")
    b = gen.mixture_rows(gen.mixture_modes(2**31 + 11, {"modes": 4}, 8, "cpu"), 50, 0.15,
                         2**31 + 11, "rows")
    c = gen.mixture_rows(gen.mixture_modes(2**31 + 12, {"modes": 4}, 8, "cpu"), 50, 0.15,
                         2**31 + 12, "rows")
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_pqbench_recall_at_k():
    truth = torch.tensor([[1, 2, 3], [4, 5, -1]])
    got = torch.tensor([[3, 9, 1], [5, 4, 7]])
    assert gen.recall_at_k(truth, got) == pytest.approx(4 / 5)


def test_pqbench_payload_parser_by_hand(tmp_path):
    cents = np.arange(6, dtype=np.float32).reshape(2, 3)
    lists = [[4, 0], [1, 2, 3]]
    body = struct.pack("<II", 3, 2) + cents.astype("<f4").tobytes()
    for lst in lists:
        body += struct.pack("<I", len(lst)) + np.asarray(lst, "<u4").tobytes()
    path = tmp_path / "p.bin"
    path.write_bytes(b"junk" + payload.MAGIC + struct.pack("<Q", len(body)) + body)
    p = payload.read_payload(path, 4)
    np.testing.assert_array_equal(p["centroids"], cents)
    np.testing.assert_array_equal(p["sizes"], [2, 3])
    np.testing.assert_array_equal(p["row_ids"], [4, 0, 1, 2, 3])
    with pytest.raises(payload.PayloadError):
        payload.read_payload(path, 0)
    path.write_bytes(payload.MAGIC + struct.pack("<Q", len(body)) + body[:-4])
    with pytest.raises(payload.PayloadError):
        payload.read_payload(path, 0)


def test_pqbench_control_roundings():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, 3.0e-3])
    t = tf32(x)
    assert t[0] == 1.0 and t[1] == 1.0  # a tie rounds to even
    assert t[2] == 1.0 + 2**-9
    assert t[3] == 1.0
    assert abs(float(t[4]) - 3.0e-3) <= 3.0e-3 * 2**-11
    assert fp8(torch.tensor([1.0 + 2**-4]))[0] == 1.0
