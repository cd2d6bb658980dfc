"""The port's copies of the benchmark data helpers
(``pqvector_tpu_torch/datasets.py``) against the originals: one seed, the
same bytes. The originals are ``synthetic_embeddings`` of
``pqvector_tpu/bench/datasets.py`` and ``generate_dataset`` and
``recall_at_k`` of the repo's ``bench.py`` (loaded from its file: it is a
script, not a module of a package)."""

import importlib.util
import pathlib

import numpy as np
import pytest

from pqvector_tpu.bench.datasets import synthetic_embeddings as j_synthetic
from pqvector_tpu_torch import datasets

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def bench():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "rows,dim,kw",
    [(1000, 16, {}), (513, 96, {"seed": 77, "n_modes": 1024}), (64, 3, {"noise": 0.5})],
)
def test_synthetic_embeddings_same_bytes(rows, dim, kw):
    got, want = datasets.synthetic_embeddings(rows, dim, **kw), j_synthetic(rows, dim, **kw)
    assert got.dtype == np.float32 and got.shape == (rows, dim)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("rows,dim,batch_rows", [(3000, 16, 1024), (70, 128, 65536)])
def test_generate_dataset_same_file(bench, tmp_path, rows, dim, batch_rows):
    a, b = tmp_path / "port.parquet", tmp_path / "original.parquet"
    datasets.generate_dataset(a, rows, dim, batch_rows=batch_rows)
    bench.generate_dataset(b, rows, dim, batch_rows=batch_rows)
    assert a.read_bytes() == b.read_bytes()


def test_generate_dataset_follows_the_seed(tmp_path):
    a, b = tmp_path / "a.parquet", tmp_path / "b.parquet"
    datasets.generate_dataset(a, 200, 8, seed=1)
    datasets.generate_dataset(b, 200, 8, seed=2)
    assert a.read_bytes() != b.read_bytes()


def test_recall_at_k_same_value(bench):
    rng = np.random.default_rng(0)
    truth = rng.integers(0, 50, (40, 10))
    got = rng.integers(-1, 50, (40, 10))
    assert datasets.recall_at_k(truth, got) == bench.recall_at_k(truth, got)
    assert datasets.recall_at_k(truth, truth) == 1.0
    assert datasets.recall_at_k(np.full((3, 4), -1), got[:3, :4]) == 0.0


def test_port_module_imports_nothing_of_the_jax_program():
    src = (ROOT / "pqvector_tpu_torch" / "datasets.py").read_text()
    smoke = (ROOT / "chip_smoke.py").read_text()
    for text in (src, smoke):
        assert "import bench" not in text and "import jax" not in text
        assert "from pqvector_tpu " not in text and "import pqvector_tpu\n" not in text
