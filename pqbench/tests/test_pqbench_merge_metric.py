"""``metrics/search.merge_lists_pct.py`` on synthetic span stores: the merge
kernel's ``merge.lists`` over ``merge.heads``, and nothing to read where the
program has no such counters."""

import json
from pathlib import Path

import pytest

from pqbench import spans
from pqbench.harness import Bench

REPO = Path(__file__).resolve().parents[2]
NAME = "search.merge_lists_pct"


@pytest.fixture(autouse=True)
def no_store():
    yield
    spans.use(spans._UNREAD)


@pytest.mark.parametrize("counters,want", [
    ({"merge.lists": 25, "merge.heads": 1000}, 2.5),
    ({"merge.lists": 0, "merge.heads": 978}, 0.0),
    ({"k4.tiles": 3, "k4.chunks": 9}, None),  # a program without the merge's counters
    ({"merge.lists": 0, "merge.heads": 0}, None),
])
def test_pqbench_merge_lists_pct_reads_the_counters(counters, want):
    spans.use({"spans": [], "dropped": 0, "counters": counters})
    got = Bench(REPO).reader(NAME)({})
    assert got == (None if want is None else pytest.approx(want))


def test_pqbench_merge_lists_pct_without_a_store():
    spans.use(None)
    assert Bench(REPO).reader(NAME)({}) is None


def test_pqbench_merge_lists_pct_is_in_the_benchmark():
    entries = {m["name"]: m for m in json.loads((REPO / "BENCHMARK.json").read_text())["per_layer"]}
    assert entries[NAME]["workloads"] == ["sift1m.search.b256", "ref1024.search.b256",
                                          "sift1m.search.b1"]
    assert entries[NAME]["source"] == "program_counter"
