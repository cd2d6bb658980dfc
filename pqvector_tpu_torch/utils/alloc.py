"""Fault-aware allocation for large host matrices.

On sandboxed microVMs first-touch page faults can dominate large-matrix
fills: the JAX package measured its native chunk decoder writing several
times faster into warm pages than into cold ones, and the cost of a cold
write varying from run to run (its docs/ROUND5.md §6, on its own host).
This is a copy of its module, with the same policy.

``alloc_matrix`` returns an mmap-backed ndarray (anonymous mmap keeps
the region out of glibc's heap so a 4 GB scratch returns to the OS on
release) and ``populate(a)`` batch-faults it with ``MADV_POPULATE_WRITE``
— one syscall's tight in-kernel loop in place of one fault per page from
the decoder's write loop. Callers that will overwrite every byte anyway
(the row-group decode loop) populate right before writing; ``populate`` is a no-op for
non-mmap arrays and unsupported kernels (pre-5.14: EINVAL), so the
fallback is always plain first-touch.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import mmap
import os

import numpy as np

#: Below this, fault cost is noise and np.empty is simpler.
_MIN_BYTES = 16 << 20

_MADV_POPULATE_WRITE = 23

_disabled = os.environ.get("PQVECTOR_TPU_NO_MMAP_ALLOC", "") not in ("", "0")

_libc = None


def _get_libc():
    global _libc
    if _libc is None:
        try:
            _libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                                use_errno=True)
        except OSError:
            _libc = False
    return _libc or None


def alloc_matrix(shape, dtype=np.float32) -> np.ndarray:
    """A C-contiguous ndarray of ``shape``/``dtype``, mmap-backed when
    large (see module docstring); np.empty otherwise."""
    dtype = np.dtype(dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    if _disabled or nbytes < _MIN_BYTES or os.name != "posix":
        return np.empty(shape, dtype)
    try:
        mm = mmap.mmap(-1, nbytes)
        return np.frombuffer(mm, dtype).reshape(shape)
    except (OSError, ValueError, OverflowError):
        return np.empty(shape, dtype)


def populate(a: np.ndarray) -> bool:
    """Batch-fault ``a``'s pages for writing (MADV_POPULATE_WRITE on the
    page-aligned span covering the array). Call right before a loop that
    overwrites every byte; harmless (returns False) when the array is
    not mmap-backed, the kernel lacks the madvise (pre-5.14), or the
    span is tiny. The array's contents are unchanged (fresh pages are
    zero; already-written pages stay put)."""
    if os.name != "posix" or a.nbytes < _MIN_BYTES:
        return False
    libc = _get_libc()
    if libc is None:
        return False
    addr = a.ctypes.data
    end = addr + a.nbytes
    page = mmap.PAGESIZE
    start = addr // page * page
    length = (end + page - 1) // page * page - start
    r = libc.madvise(ctypes.c_void_p(start), ctypes.c_size_t(length),
                     _MADV_POPULATE_WRITE)
    return r == 0
