"""The port's entry points run on the CUDA card unless the caller names a
device: ``device=None`` resolves to the card and raises where there is none;
it never falls back to the CPU."""

import numpy as np
import pytest
import torch

import pqvector_tpu_torch as pqt
from pqvector_tpu_torch._device import resolve_device
from pqvector_tpu_torch.convert import searcher_state_from_reference
from pqvector_tpu_torch.index.kmeans import KMeansParams, k_means
from pqvector_tpu_torch.kernels.assign import assign_clusters
from pqvector_tpu_torch.types import Embeddings


def _entry_points(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = tmp_path / "d.parquet"
    pq.write_table(pa.table({"vec": pa.FixedSizeListArray.from_arrays(
        pa.array(x.reshape(-1)), 8)}), path)
    index = pqt.build_ivf_index(Embeddings(x, 8), pqt.IvfBuildConfig(n_clusters=4),
                                device="cpu")
    pqt.IndexBuilder(path, "vec", device="cpu").n_clusters(4).build_inplace()
    return {
        "IndexBuilder": lambda **kw: pqt.IndexBuilder(path, "vec", **kw),
        "build_ivf_index": lambda **kw: pqt.build_ivf_index(
            Embeddings(x, 8), pqt.IvfBuildConfig(n_clusters=4), **kw),
        "k_means": lambda **kw: k_means(x, KMeansParams(n_clusters=4), **kw),
        "assign_clusters": lambda **kw: assign_clusters(x, x[:4], **kw),
        "DeviceIvfSearcher": lambda **kw: pqt.DeviceIvfSearcher(index, x, row_tile=64, **kw),
        "from_parquet": lambda **kw: pqt.DeviceIvfSearcher.from_parquet(
            path, row_tile=64, **kw),
        "searcher_state_from_reference": lambda **kw: searcher_state_from_reference(
            {"emb": x}, **kw),
    }


NAMES = ["IndexBuilder", "build_ivf_index", "k_means", "assign_clusters",
         "DeviceIvfSearcher", "from_parquet", "searcher_state_from_reference"]


@pytest.mark.parametrize("name", NAMES)
def test_default_device_raises_without_a_card(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    call = _entry_points(tmp_path)[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    call(device="cpu")  # asking for the CPU works


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")) == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (sm_90a)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_default_device_is_the_card(cuda_device, tmp_path):
    assert resolve_device(None).type == "cuda"
    calls = _entry_points(tmp_path)
    s = calls["DeviceIvfSearcher"]()
    assert s.device.type == "cuda" and s.emb.is_cuda
    assert calls["from_parquet"]().emb.is_cuda
    assert calls["searcher_state_from_reference"]()["emb"].is_cuda
    assert calls["IndexBuilder"]()._device.type == "cuda"
    calls["build_ivf_index"]()
    calls["k_means"]()
    calls["assign_clusters"]()
