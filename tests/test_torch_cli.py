"""``python -m pqvector_tpu_torch`` against ``python -m pqvector_tpu`` on one
indexed file: ``info`` and the host ``search`` print the JAX CLI's lines;
``search --device-mode`` prints its ids, distances within 1e-5. The port's
CLI runs as a subprocess (with the repo on ``PYTHONPATH``) where the test is
about the module entry point, in process elsewhere."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from pqvector_tpu.__main__ import main as jmain
from pqvector_tpu.builder import IndexBuilder as JIndexBuilder
from pqvector_tpu_torch.__main__ import main as tmain
from pqvector_tpu_torch.io.embed import has_pq_vector_index

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_cli(*args):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "pqvector_tpu_torch", *map(str, args)],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


def _jax_cli(capsys, *args):
    capsys.readouterr()
    rc = jmain([str(a) for a in args])
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def indexed(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((300, 8)).astype(np.float32)
    path = root / "c.parquet"
    pq.write_table(pa.table({"embedding": pa.array(list(vecs), pa.list_(pa.float32()))}),
                   path, row_group_size=64)
    shutil.copy(path, root / "plain.parquet")
    JIndexBuilder(path, "embedding").n_clusters(6).build_inplace()
    return path, root / "plain.parquet"


def test_info_prints_jax_lines(indexed, capsys):
    path, plain = indexed
    out = _port_cli("info", path)
    rc, want = _jax_cli(capsys, "info", path)
    assert out.returncode == rc == 0, out.stderr
    assert out.stdout == want
    out = _port_cli("info", plain)
    rc, want = _jax_cli(capsys, "info", plain)
    assert out.returncode == rc == 1
    assert out.stdout == want


@pytest.mark.parametrize("row,k,nprobe", [(5, 3, 4), (0, 10, 1), (299, 7, 6)])
def test_host_search_prints_jax_lines(indexed, capsys, row, k, nprobe):
    path, _ = indexed
    args = ["search", path, "--query-row", row, "-k", k, "--nprobe", nprobe]
    rc, want = _jax_cli(capsys, *args)
    assert tmain([str(a) for a in args] + ["--device", "cpu"]) == rc == 0
    assert capsys.readouterr().out == want


def _hits(text):
    rows = [line.split("\t") for line in text.strip().splitlines()]
    return [int(i) for i, _ in rows], np.array([float(d) for _, d in rows])


@pytest.mark.parametrize("mode", ["gather", "auto", "pallas", "masked"])
def test_device_search_matches_jax(indexed, capsys, mode):
    path, _ = indexed
    args = ["search", path, "--query-row", "17", "-k", "5", "--nprobe", "3",
            "--device-mode", mode]
    rc, want = _jax_cli(capsys, *args)
    assert tmain([str(a) for a in args] + ["--device", "cpu"]) == rc == 0
    got_ids, got_d = _hits(capsys.readouterr().out)
    want_ids, want_d = _hits(want)
    assert got_ids == want_ids
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-6)


def test_device_search_module_entry_point(indexed):
    path, _ = indexed
    out = _port_cli("search", path, "--query-row", "17", "-k", "5", "--nprobe", "3",
                    "--device-mode", "gather", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    ids, _ = _hits(out.stdout)
    assert ids[0] == 17 and len(ids) == 5


def test_build_then_info_and_search(indexed, tmp_path, capsys):
    _, plain = indexed
    path = tmp_path / "b.parquet"
    shutil.copy(plain, path)
    assert tmain(["build", str(path), "--n-clusters", "4", "--device", "cpu"]) == 0
    assert has_pq_vector_index(path)
    assert "index embedded in place" in capsys.readouterr().out
    assert tmain(["info", str(path)]) == 0
    assert "clusters         : 4" in capsys.readouterr().out
    assert tmain(["search", str(path), "--query-row", "5", "-k", "3", "--nprobe", "4",
                  "--device", "cpu"]) == 0
    assert capsys.readouterr().out.splitlines()[0].startswith("5\t0.0")


@pytest.mark.parametrize("extra", [["--output", "OUT"], ["--output", "OUT", "--cluster-sorted"],
                                   ["--transfer-dtype", "bfloat16"]])
def test_unported_build_options_exit_1(indexed, tmp_path, extra):
    _, plain = indexed
    path = tmp_path / "u.parquet"
    shutil.copy(plain, path)
    extra = [str(tmp_path / "out.parquet") if a == "OUT" else a for a in extra]
    out = _port_cli("build", path, "--n-clusters", "4", "--device", "cpu", *extra)
    assert out.returncode == 1
    assert "not ported" in out.stderr and "Traceback" not in out.stderr
    assert not has_pq_vector_index(path)


def test_errors_exit_1_without_traceback(indexed, capsys):
    path, _ = indexed
    # A file-order searcher has no cluster-sorted layout for "stream".
    assert tmain(["search", str(path), "--device-mode", "stream", "--device", "cpu"]) == 1
    assert "cluster-sorted" in capsys.readouterr().err


def test_default_device_is_the_card(indexed, capsys):
    """Without ``--device`` the CLI runs on the card, and exits 1 with the
    device error where there is none (no CPU fallback)."""
    path, _ = indexed
    rc = tmain(["search", str(path), "--device-mode", "gather"])
    if torch.cuda.is_available():
        assert rc == 0
    else:
        assert rc == 1
        assert "no CUDA device" in capsys.readouterr().err


def test_host_search_needs_no_device(indexed, capsys):
    """``search`` without ``--device-mode`` is TopkBuilder's host code: it
    runs with no ``--device`` and prints the same lines as with one."""
    path, _ = indexed
    assert tmain(["search", str(path), "--query-row", "3"]) == 0
    default = capsys.readouterr().out
    assert tmain(["search", str(path), "--query-row", "3", "--device", "cpu"]) == 0
    assert capsys.readouterr().out == default != ""
