"""The PyTorch port's example scripts and its kernel cache on the CPU.

Twin of ``tests/test_examples.py``: each ``examples/torch_*.py`` runs as a
real subprocess with ``--device cpu`` against the same 300 x 16 file and
``PQ_VECTOR_*`` environment, prints what the JAX test asserts, and prints
the ids the JAX example prints on the same file. Then ``utils/cache.py``:
``enable_compilation_cache`` moves the kernel build directory, the
no-cache variable gives each process a directory of its own, and importing
the package runs no nvcc.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
SCRIPTS = ["build_index", "topk_search", "sql_query", "serving"]


def _env(tmp, source):
    env = dict(os.environ)
    env.update(
        PQ_VECTOR_SOURCE=str(source),
        PQ_VECTOR_INDEXED=str(tmp / "indexed.parquet"),
        PQ_VECTOR_QUERY_ROW="7",
        JAX_PLATFORMS="cpu",
    )
    return env


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """stdout of every example, the port's (``--device cpu``) and the JAX
    package's, each package in a directory of its own over one source."""
    root = tmp_path_factory.mktemp("examples")
    source = root / "src.parquet"
    vecs = np.random.default_rng(4).standard_normal((300, 16)).astype(np.float32)
    pq.write_table(
        pa.table({
            "id": pa.array(range(300), pa.int64()),
            "title": pa.array([f"row {i}" for i in range(300)]),
            "embedding": pa.array(list(vecs), pa.list_(pa.float32())),
        }),
        source,
    )
    out = {}
    for package, prefix, extra in (("torch", "torch_", ["--device", "cpu"]),
                                   ("jax", "", [])):
        tmp = root / package
        tmp.mkdir()
        shutil.copy(source, tmp / "src.parquet")
        env = _env(tmp, tmp / "src.parquet")
        for name in SCRIPTS:
            proc = subprocess.run(
                [sys.executable, os.path.join(EXAMPLES, f"{prefix}{name}.py"), *extra],
                env=env, cwd=EXAMPLES, capture_output=True, text=True, timeout=300,
            )
            assert proc.returncode == 0, (
                f"{prefix}{name}.py failed:\n{proc.stdout}\n{proc.stderr}")
            out[package, name] = proc.stdout
    return out


def _id_lines(text):
    """The lines that carry result ids: top-k rows, ``... ids...:`` lines
    and the SQL result table's rows."""
    keep = re.compile(r"^\s*row=|ids|^\d+\s+\d+\s+row \d+$")
    return [line for line in text.splitlines() if keep.search(line)]


def test_build_index_example(outputs):
    out = outputs["torch", "build_index"]
    assert "indexed copy ready" in out
    assert "has_pq_vector_index=True" in out


def test_topk_search_example(outputs):
    out = outputs["torch", "topk_search"]
    assert "row=       7  distance=0.0000" in out
    assert "batched ids[0]:" in out


def test_sql_query_example(outputs):
    out = outputs["torch", "sql_query"]
    assert "vector_topk" in out
    assert "row 7" in out


def test_serving_example(outputs):
    out = outputs["torch", "serving"]
    assert "scan ids[0]:" in out
    assert "loop ids[0]:" in out
    assert "sql ids:" in out


@pytest.mark.parametrize("name", SCRIPTS[1:])
def test_examples_print_the_jax_examples_ids(outputs, name):
    """The same ids (and top-k distances to 4 places) as the JAX example."""
    got, want = _id_lines(outputs["torch", name]), _id_lines(outputs["jax", name])
    assert got and got == want


def test_examples_import_only_the_port():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|pqvector_tpu)\b(?!_torch)", re.M)
    for name in ["common", *SCRIPTS]:
        with open(os.path.join(EXAMPLES, f"torch_{name}.py")) as f:
            assert not pattern.search(f.read()), name


# ---------------------------------------------------------------- the cache


def test_enable_compilation_cache_moves_the_build_dir(tmp_path, monkeypatch):
    from pqvector_tpu_torch.kernels import _build
    from pqvector_tpu_torch.utils.cache import enable_compilation_cache

    monkeypatch.delenv("PQVECTOR_TPU_NO_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    default = _build.BUILD_DIR
    assert default == _build._PKG / "_build"
    enable_compilation_cache()
    assert _build.BUILD_DIR == default
    enable_compilation_cache(tmp_path / "kernels")
    assert _build.BUILD_DIR == tmp_path / "kernels"


def _probe(env, code):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **env)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


_SHOW_DIR = ("import os, pqvector_tpu_torch\n"
             "from pqvector_tpu_torch.kernels import _build\n"
             "print(_build.BUILD_DIR, os.path.isdir(_build.BUILD_DIR))")


def test_no_cache_variable_gives_each_process_its_own_dir(tmp_path):
    """Under ``PQVECTOR_TPU_NO_COMPILE_CACHE`` each process builds in a
    temporary directory of its own, gone when the process ends."""
    env = {"PQVECTOR_TPU_NO_COMPILE_CACHE": "1", "TMPDIR": str(tmp_path)}
    seen = [_probe(env, _SHOW_DIR).rsplit(" ", 1) for _ in range(2)]
    assert seen[0][0] != seen[1][0]
    for path, existed in seen:
        assert existed == "True"
        assert os.path.dirname(path) == str(tmp_path)
        assert not os.path.exists(path)
    path, _ = _probe({}, _SHOW_DIR).rsplit(" ", 1)
    assert path == os.path.join(REPO, "pqvector_tpu_torch", "_build")


def test_import_runs_no_nvcc(tmp_path):
    """Importing the package and every module of it builds nothing: an
    ``nvcc`` on the path and under ``CUDA_HOME`` that leaves a mark is
    never called, and no library is loaded."""
    fake = tmp_path / "cuda" / "bin"
    fake.mkdir(parents=True)
    mark = tmp_path / "nvcc_ran"
    (fake / "nvcc").write_text(f"#!/bin/sh\ntouch {mark}\nexit 1\n")
    (fake / "nvcc").chmod(0o755)
    code = ("import pkgutil, importlib, pqvector_tpu_torch\n"
            "for m in pkgutil.walk_packages(pqvector_tpu_torch.__path__, "
            "'pqvector_tpu_torch.'):\n"
            "    if not m.name.endswith('__main__'):\n"
            "        importlib.import_module(m.name)\n"
            "from pqvector_tpu_torch.kernels import _build\n"
            "print(_build._lib is None, _build.build_seconds)")
    env = {"CUDA_HOME": str(tmp_path / "cuda"),
           "PATH": str(fake) + os.pathsep + os.environ.get("PATH", "")}
    assert _probe(env, code) == "True 0.0"
    assert not mark.exists()
