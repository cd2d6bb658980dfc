"""``correct`` comes out false when the timed path is broken underneath, and
for the control; true for the program as it is. The harness's look for a
card is skipped: the cells run on the CPU at a tiny size."""

import json
import types

import numpy as np
import pytest
import torch

import pqvector_tpu_torch
from pqvector_tpu_torch import builder as builder_mod
from pqvector_tpu_torch.index import kmeans as kmeans_mod
from pqbench.reference.control import ControlSearcher, control_build
from pqbench.tests.tiny import make_root, run_tiny

REAL = pqvector_tpu_torch.DeviceIvfSearcher


def program_with(searcher_cls):
    return types.SimpleNamespace(
        __name__=pqvector_tpu_torch.__name__, IvfIndex=pqvector_tpu_torch.IvfIndex,
        DeviceIvfSearcher=searcher_cls, IndexBuilder=pqvector_tpu_torch.IndexBuilder)


class Stale(REAL):
    """Returns its state unchanged: the previous call's answer."""

    last = None

    def search(self, q, k, nprobe, mode="auto"):
        out = super().search(q, k, nprobe, mode=mode)
        prev, self.last = self.last, out
        return out if prev is None else prev


class HalfBatch(REAL):
    """Answers the first half of the batch only."""

    def search(self, q, k, nprobe, mode="auto"):
        d, ids = super().search(q[: q.shape[0] // 2], k, nprobe, mode=mode)
        rest = q.shape[0] - d.shape[0]
        return (torch.cat([d, torch.full((rest, k), torch.inf)]),
                torch.cat([ids, torch.full((rest, k), -1, dtype=ids.dtype)]))


class Altered(REAL):
    """Alters one answer where it is produced: query 0's best id."""

    def search(self, q, k, nprobe, mode="auto"):
        d, ids = super().search(q, k, nprobe, mode=mode)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % self.n
        return d, ids


@pytest.mark.parametrize("cls", [Stale, HalfBatch, Altered], ids=lambda c: c.__name__)
def test_pqbench_search_fault_is_not_correct(tmp_path, cls):
    result, _ = run_tiny(make_root(tmp_path), "tiny.search", program=program_with(cls))
    assert result["correct"] is False
    json.dumps(result, allow_nan=False)  # the line stays strict JSON


def test_pqbench_search_control_is_not_correct(tmp_path):
    class Control(REAL):
        def __init__(self, index, rows, **kw):
            from pqbench.reference.exact import Layout

            super().__init__(index, rows, **kw)
            assign = np.empty(index.total_rows, np.int64)
            assign[index.row_ids] = np.repeat(np.arange(index.n_clusters), index.cluster_sizes())
            self.control = ControlSearcher(Layout(torch.from_numpy(rows), torch.from_numpy(assign),
                                                  torch.from_numpy(index.centroids)))

        def search(self, q, k, nprobe, mode="auto"):
            return self.control.search(q, k, nprobe)

    root = make_root(tmp_path)
    sound, _ = run_tiny(root, "tiny.search")
    control, rows = run_tiny(root, "tiny.search", program=program_with(Control))
    assert sound["correct"] is True and control["correct"] is False
    over = [name for name, value, limit in rows if value > limit]
    assert "dist_err" in over


def _wrap_append(monkeypatch, alter):
    real = builder_mod.append_index_inplace

    def append(path, index, column, metric="l2"):
        return real(path, alter(index), column, metric=metric)

    monkeypatch.setattr(builder_mod, "append_index_inplace", append)


def _lists(index):
    return [np.asarray(index.cluster_rows(c)) for c in range(index.n_clusters)]


def test_pqbench_build_unchanged_state_is_not_correct(tmp_path, monkeypatch):
    calls = {"n": 0}
    real = builder_mod.append_index_inplace

    def append(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 1:  # the warm build appends; the window's do not
            real(*args, **kw)

    monkeypatch.setattr(builder_mod, "append_index_inplace", append)
    result, _ = run_tiny(make_root(tmp_path), "tiny.build")
    assert result["correct"] is False


def test_pqbench_build_half_left_out_is_not_correct(tmp_path, monkeypatch):
    def half(index):
        lists = [lst[lst < index.total_rows // 2] for lst in _lists(index)]
        return type(index).from_lists(index.dim, index.centroids, lists)

    _wrap_append(monkeypatch, half)
    result, _ = run_tiny(make_root(tmp_path), "tiny.build")
    assert result["correct"] is False


def test_pqbench_build_altered_answer_is_not_correct(tmp_path, monkeypatch):
    def moved(index):
        lists = _lists(index)
        row, lists[0] = lists[0][0], lists[0][1:]
        far = int(np.argmax(((index.centroids - index.centroids[0]) ** 2).sum(1)))
        lists[far] = np.append(lists[far], row)
        return type(index).from_lists(index.dim, index.centroids, lists)

    _wrap_append(monkeypatch, moved)
    result, _ = run_tiny(make_root(tmp_path), "tiny.build")
    assert result["correct"] is False


def test_pqbench_build_without_lloyd_is_not_correct(tmp_path, monkeypatch):
    """k-means keeps its k-means++ seeds: every row still sits under its
    nearest centroid, and only the training's number can see it."""
    from pqbench.calibrate import no_lloyd

    monkeypatch.setattr(kmeans_mod, "_lloyd", kmeans_mod._lloyd)  # undone after the test
    no_lloyd(pqvector_tpu_torch)
    result, rows = run_tiny(make_root(tmp_path), "tiny.build")
    assert result["correct"] is False
    assert [name for name, value, limit in rows if value > limit] == ["kmeans_excess"]


def test_pqbench_build_control_is_not_correct(tmp_path, monkeypatch):
    root = make_root(tmp_path)
    sound, _ = run_tiny(root, "tiny.build")
    assert sound["correct"] is True

    def by_control(index):
        import pyarrow.parquet as pq

        del index
        path = by_control.path
        emb = pq.read_table(path, columns=["embedding"]).column("embedding").combine_chunks()
        rows = torch.from_numpy(emb.values.to_numpy().reshape(len(emb), -1).copy())
        p = control_build(rows, 24, 8, 42)
        lists = np.split(p["row_ids"], np.cumsum(p["sizes"])[:-1])
        return pqvector_tpu_torch.IvfIndex.from_lists(p["dim"], p["centroids"], lists)

    real = builder_mod.append_index_inplace

    def append(path, index, column, metric="l2"):
        by_control.path = path
        return real(path, by_control(index), column, metric=metric)

    monkeypatch.setattr(builder_mod, "append_index_inplace", append)
    result, rows = run_tiny(root, "tiny.build")
    assert result["correct"] is False
    assert [name for name, value, limit in rows if value > limit] == ["assign_excess"]
