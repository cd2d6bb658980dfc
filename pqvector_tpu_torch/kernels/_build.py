"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

At first CUDA use, ``nvcc`` compiles every source under ``csrc/`` (one
process per source, all at once) and links the objects into one shared
library with a plain C interface under ``pqvector_tpu_torch/_build/``;
``ctypes`` loads it. The library's name carries a hash of the sources
and flags, so an edited source builds anew. Nothing here runs at import:
the CPU tests import every module and have no ``nvcc``.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a run resets
it to show which kernels a path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

#: Launches per kernel (K1 assign, K2 stream exact, K3 stream masked,
#: K4 masked local, K5 exact per-tile, K6 masked per-tile, K7 binned scan,
#: K8 binned scan over selected tiles, K9 tile min, K10 tile gather, K11 tile
#: gather by bulk copies) since the last ``reset_launches``; "K1_bf16" counts
#: those of K1's launches that took a bf16-row form: the screen
#: ("K1_bf16_screen"), the FMA form over the rows the screen left uncertified
#: ("K1_bf16_rescore") and the FMA form over all rows; "K1_f32_screen" and
#: "K1_f32_rescore" those of K1's launches on f32 rows that took the f32-row
#: screen and ``pqv_assign`` over the rows it left uncertified; "merge" the
#: cross-tile merge of K4's, K5's and K6's per-tile lists.
LAUNCHES: dict[str, int] = {**{f"K{i}": 0 for i in range(1, 12)}, "K1_bf16": 0,
                            "K1_bf16_screen": 0, "K1_bf16_rescore": 0,
                            "K1_f32_screen": 0, "K1_f32_rescore": 0, "merge": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_SIGNATURES = {
    "pqv_assign": [_P, _P, _P, _I, _I, _I, _P, _P],
    "pqv_assign_bf16": [_P, _P, _P, _I, _I, _I, _P, _P],
    "pqv_assign_smem": [],
    "pqv_assign_bf16_screen": [_P, _P, _P, _I, _I, _I, _D, _D, _D, _P, _P, _P, _P],
    "pqv_assign_bf16_smem": [_I],
    "pqv_assign_f32_screen": [_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "pqv_assign_f32_screen_smem": [],
    "pqv_assign_f32_screen_pairs": [_P, _P],
    "pqv_stream_exact_topk": [_P, _P, _P] + [_I] * 7 + [_P] * 6,
    "pqv_stream_exact_topk_smem": [_I] * 3,
    "pqv_stream_masked_topk": [_P] * 5 + [_I] * 8 + [_P] * 8,
    "pqv_stream_masked_topk_scratch": [_I] * 3,
    "pqv_stream_masked_topk_smem": [_I] * 2,
    "pqv_masked_local_topk": [_P] * 5 + [_I] * 9 + [_P] * 4,
    "pqv_masked_local_topk_smem": [_I] * 4,
    "pqv_exact_topk": [_P] * 3 + [_I] * 7 + [_P] * 3,
    "pqv_exact_topk_smem": [_I] * 3,
    "pqv_masked_topk": [_P] * 5 + [_I] * 9 + [_P] * 4,
    "pqv_masked_topk_smem": [_I] * 4,
    "pqv_binned_scan": [_P] * 6 + [_I] * 10 + [_P] * 2,
    "pqv_binned_scan_select": [_P] * 7 + [_I] * 10 + [_P] * 2,
    "pqv_binned_scan_smem": [_I] * 2,
    "pqv_tile_min": [_P] * 3 + [_I] * 7 + [_P] * 2,
    "pqv_tile_min_smem": [_I] * 2,
    "pqv_tile_gather": [_P] * 5 + [_I, _L, _L, _I, _I, _P],
    "pqv_tile_gather_dma": [_P] * 5 + [_I, _L, _L, _P],
    "pqv_merge_lists": [_P, _P] + [_I] * 4 + [_P] * 4,
}

_lib: ctypes.CDLL | None = None
#: Seconds the last ``load`` spent compiling (0.0 when it found the library).
build_seconds = 0.0


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _check_device() -> None:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the Hopper kernels need a CUDA device")
    cap = torch.cuda.get_device_capability()
    if cap != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); device capability is {cap}"
        )


def load() -> ctypes.CDLL:
    """The kernel library, compiled on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    _check_device()
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = BUILD_DIR / f"libpqv_kernels_{digest.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        outs = [p.communicate() for p in procs]
        _check_nvcc([(p.returncode, o, e) for p, (o, e) in zip(procs, outs)])
        _check_nvcc([_run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)])])
        for obj in objs:
            obj.unlink()
        os.replace(tmp, out)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _run(cmd: list[str]) -> tuple[int, str, str]:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc.returncode, proc.stdout, proc.stderr


def _check_nvcc(results) -> None:
    for rc, out, err in results:
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{out}\n{err}")


def check(rc: int, name: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
