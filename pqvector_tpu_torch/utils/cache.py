"""Persistent cache of the compiled kernels, across processes.

Counterpart of ``pqvector_tpu/utils/cache.py``, whose contract is a disk
cache of compiled device code. Here that code is the nvcc library of
``csrc/*.cu``: ``kernels/_build.py`` writes it under ``BUILD_DIR``
(``pqvector_tpu_torch/_build/`` by default), named by a hash of the sources
and flags, so the first process compiles and every later one loads it.
``enable_compilation_cache`` runs at package import; it never compiles and
never raises.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path


def enable_compilation_cache(cache_dir: str | os.PathLike | None = None) -> None:
    """Point the kernel build at ``cache_dir`` (when given). Under
    ``PQVECTOR_TPU_NO_COMPILE_CACHE`` each process builds into a temporary
    directory of its own, removed at exit, so every process compiles, as
    the JAX package then compiles in every process. Takes effect for a
    library not loaded yet."""
    try:
        from ..kernels import _build

        if os.environ.get("PQVECTOR_TPU_NO_COMPILE_CACHE"):
            own = tempfile.mkdtemp(prefix="pqvector_kernels_")
            atexit.register(shutil.rmtree, own, ignore_errors=True)
            _build.BUILD_DIR = Path(own)
        elif cache_dir is not None:
            _build.BUILD_DIR = Path(cache_dir)
    except Exception:  # noqa: BLE001 - the cache is an optimization only
        pass
