"""ctypes bindings to the native host library (native/libpqvector_host.so).

The C++ library implements the Thrift footer splice, the full in-place
index embed (see native/pqvector_host.cpp) and the Parquet page decoders
(native/pqvector_pages.cpp) that ``io/pages.py`` uses when the library is
present, falling back to its Python decoder otherwise. This is a copy of the
JAX package's bindings to the same library. ``ensure_built()`` compiles it on
demand from the repo's ``native/`` sources with the system g++.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

from ..errors import FormatError
from ..utils.alloc import alloc_matrix, populate

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpqvector_host.so")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False

_ERRORS = {
    -1: "truncated thrift buffer",
    -2: "malformed thrift metadata",
    -3: "output capacity too small",
    -4: "I/O error",
    -5: "Encrypted parquet footers are not supported for in-place indexing",
    -6: "not a valid parquet file",
    -7: "decompression failed",
    -8: "unsupported page encoding/type",
}


#: zstd's two declarations (``zstd_decl/zstd.h``), on the include path
#: ahead of the system's, so the library builds on hosts that carry the
#: runtime ``libzstd.so.1`` but not zstd's development header.
_ZSTD_DECL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zstd_decl")


def ensure_built(force: bool = False) -> bool:
    """Compile the native library if needed; True if it is available.

    ``make`` in the repo's ``native/`` builds it from its sources, against
    the declarations in ``zstd_decl/`` and the runtime ``libzstd.so.1``."""
    if os.path.exists(_LIB_PATH) and not force:
        return True
    if not os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        return False
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "LDLIBS=-l:libzstd.so.1 -lz"],
            check=True,
            capture_output=True,
            timeout=120,
            env=dict(os.environ, CPLUS_INCLUDE_PATH=_ZSTD_DECL_DIR),
        )
    except (subprocess.SubprocessError, OSError):
        return False
    return os.path.exists(_LIB_PATH)


def load() -> ctypes.CDLL | None:
    """Load (building if necessary) the native library, or None."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed or os.environ.get("PQVECTOR_TPU_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if not ensure_built():
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
            # A stale .so from an older checkout lacks newer entry points
            # (symbol lookup raises AttributeError at binding time below,
            # which would escape to callers expecting the None fallback).
            # Rebuild once if the newest symbol is missing.
            if not hasattr(lib, "pqv_assign_margin_bf16"):
                del lib
                if not ensure_built(force=True):
                    _load_failed = True
                    return None
                lib = ctypes.CDLL(_LIB_PATH)
                if not hasattr(lib, "pqv_assign_margin_bf16"):
                    _load_failed = True
                    return None
        except OSError:
            _load_failed = True
            return None
        lib.pqv_splice_kv.restype = ctypes.c_int64
        lib.pqv_splice_kv.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_size_t,
            ctypes.c_char_p,
            ctypes.c_size_t,
        ]
        lib.pqv_append_index_inplace.restype = ctypes.c_int
        lib.pqv_append_index_inplace.argtypes = [
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_size_t,
        ]
        lib.pqv_version.restype = ctypes.c_char_p
        lib.pqv_decode_data_page.restype = ctypes.c_int64
        lib.pqv_decode_data_page.argtypes = [
            ctypes.c_char_p,  # raw page bytes
            ctypes.c_size_t,
            ctypes.c_char_p,  # codec
            ctypes.c_int32,  # ptype
            ctypes.c_int32,  # max_def
            ctypes.c_int32,  # max_rep
            ctypes.c_void_p,  # out_values (float32*)
            ctypes.c_size_t,
            ctypes.c_void_p,  # out_row_lengths (int64*)
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_int64),  # out_num_values
        ]
        lib.pqv_decode_pages.restype = ctypes.c_int64
        lib.pqv_decode_pages.argtypes = [
            ctypes.c_char_p,  # concatenated page bytes
            ctypes.c_size_t,
            ctypes.c_void_p,  # page offsets (uint64*)
            ctypes.c_void_p,  # page lens (uint64*)
            ctypes.c_size_t,  # n_pages
            ctypes.c_char_p,  # codec
            ctypes.c_int32,  # ptype
            ctypes.c_int32,  # max_def
            ctypes.c_int32,  # max_rep
            ctypes.c_void_p,  # out_values (float32*)
            ctypes.c_size_t,
            ctypes.c_void_p,  # out_row_lengths (int64*)
            ctypes.c_size_t,
            ctypes.c_void_p,  # page_value_start (int64*, n_pages+1)
            ctypes.c_void_p,  # page_row_start (int64*, n_pages+1)
        ]
        lib.pqv_decode_chunk.restype = ctypes.c_int64
        lib.pqv_decode_chunk.argtypes = [
            ctypes.c_char_p,  # whole column chunk bytes
            ctypes.c_size_t,
            ctypes.c_char_p,  # codec
            ctypes.c_int32,  # ptype
            ctypes.c_int32,  # max_def
            ctypes.c_int32,  # max_rep
            ctypes.c_void_p,  # out_values (float32*)
            ctypes.c_size_t,
            ctypes.c_void_p,  # out_row_lengths (int64*)
            ctypes.c_size_t,
            ctypes.c_void_p,  # out_num_values (int64*)
        ]
        if hasattr(lib, "pqv_quantize_i8"):
            lib.pqv_quantize_i8.restype = ctypes.c_int
            lib.pqv_quantize_i8.argtypes = [
                ctypes.c_void_p,  # in (float32*)
                ctypes.c_int64,  # n rows
                ctypes.c_int64,  # dim
                ctypes.c_void_p,  # out codes (int8*)
                ctypes.c_void_p,  # out scales (float32*)
            ]
        if hasattr(lib, "pqv_cast_bf16"):
            lib.pqv_cast_bf16.restype = ctypes.c_int
            lib.pqv_cast_bf16.argtypes = [
                ctypes.c_void_p,  # in (float32*)
                ctypes.c_int64,  # element count
                ctypes.c_void_p,  # out (uint16* bf16 bits)
            ]
        if hasattr(lib, "pqv_assign_argmin"):
            lib.pqv_assign_argmin.restype = ctypes.c_int
            lib.pqv_assign_argmin.argtypes = [
                ctypes.c_void_p,  # scores (float32*, [n,k] row-major)
                ctypes.c_int64,  # n rows
                ctypes.c_int64,  # k centroids
                ctypes.c_void_p,  # bias |c|^2 (float32*, [k])
                ctypes.c_void_p,  # out assignments (int32*, [n])
            ]
        _lib = lib
        return _lib


def _str_array(items: list[str]):
    arr = (ctypes.c_char_p * max(len(items), 1))()
    for i, s in enumerate(items):
        arr[i] = s.encode("utf-8")
    return arr


def splice_key_value_metadata_native(
    metadata: bytes,
    set_pairs: list[tuple[str, str]],
    drop_keys: frozenset[str] | set[str] = frozenset(),
) -> bytes | None:
    """Native splice; None if the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    keys = _str_array([k for k, _ in set_pairs])
    vals = _str_array([v for _, v in set_pairs])
    drops = _str_array(sorted(drop_keys))
    size = lib.pqv_splice_kv(
        metadata,
        len(metadata),
        keys,
        vals,
        len(set_pairs),
        drops,
        len(drop_keys),
        None,
        0,
    )
    if size < 0:
        raise FormatError(_ERRORS.get(size, f"native splice error {size}"))
    out = ctypes.create_string_buffer(int(size))
    rc = lib.pqv_splice_kv(
        metadata,
        len(metadata),
        keys,
        vals,
        len(set_pairs),
        drops,
        len(drop_keys),
        ctypes.cast(out, ctypes.c_char_p),
        int(size),
    )
    if rc < 0:
        raise FormatError(_ERRORS.get(rc, f"native splice error {rc}"))
    return out.raw[: int(size)]


def append_index_inplace_native(
    path: str,
    index_bytes: bytes,
    column: str,
    offset_key: str,
    column_key: str,
    magic: bytes,
    extra_kv: dict[str, str] | None = None,
    extra_drop_keys: tuple[str, ...] = (),
) -> bool:
    """Native in-place embed; False if the library is unavailable.

    ``extra_drop_keys``: keys from previous appends that this call does not
    set but must strip anyway (e.g. a stale ``pq_vector_metric`` when
    rebuilding an indexed cosine file with the default l2 metric).
    """
    lib = load()
    if lib is None:
        return False
    extra = list((extra_kv or {}).items())
    drops = [k for k in extra_drop_keys if k not in dict(extra)]
    rc = lib.pqv_append_index_inplace(
        os.fspath(path).encode(),
        index_bytes,
        len(index_bytes),
        column.encode(),
        offset_key.encode(),
        column_key.encode(),
        magic,
        len(magic),
        _str_array([k for k, _ in extra]),
        _str_array([v for _, v in extra]),
        len(extra),
        _str_array(drops),
        len(drops),
    )
    if rc != 0:
        raise FormatError(_ERRORS.get(rc, f"native append error {rc}"))
    return True


def decode_data_page_native(
    raw: bytes, codec: str, ptype: int, max_def: int, max_rep: int
):
    """Native page decode; returns (values f32 [n], row_lengths i64 [rows])
    or None when the library is unavailable. Raises FormatError on decode
    errors (caller may fall back to the Python decoder for unsupported
    encodings)."""
    import numpy as np

    lib = load()
    if lib is None:
        return None
    # A page cannot hold more values than bytes.
    cap = max(len(raw), 16)
    values = np.empty(cap, dtype=np.float32)
    row_lengths = np.empty(cap, dtype=np.int64)
    num_values = ctypes.c_int64(0)
    rows = lib.pqv_decode_data_page(
        raw,
        len(raw),
        codec.encode(),
        ptype,
        max_def,
        max_rep,
        values.ctypes.data_as(ctypes.c_void_p),
        cap,
        row_lengths.ctypes.data_as(ctypes.c_void_p),
        cap,
        ctypes.byref(num_values),
    )
    if rows < 0:
        raise FormatError(
            _ERRORS.get(rows, f"native page decode error {rows}")
        )
    return values[: num_values.value].copy(), row_lengths[:rows].copy()


def decode_chunk_native(
    buf,
    codec: str,
    ptype: int,
    max_def: int,
    max_rep: int,
    row_cap: int,
    value_cap: int,
    out_values=None,
):
    """Sequential decode of a whole column chunk (no offset index).

    Returns ``(values f32 [nv], row_lengths i64 [nr])`` or None when the
    library is unavailable; raises FormatError for unsupported layouts
    (dictionary pages, non-PLAIN encodings, nulls) so callers can fall
    back to pyarrow. ``out_values`` may be a preallocated f32 array of at
    least ``value_cap`` elements (decode writes in place, no copy).
    """
    import numpy as np

    lib = load()
    if lib is None:
        return None
    if not isinstance(buf, bytes):
        buf = (ctypes.c_char * len(buf)).from_buffer(buf)
    if out_values is not None:
        values = out_values
    else:
        values = alloc_matrix((value_cap,), np.float32)
        populate(values)  # batch-fault before the decoder's write loop
    if values.size < value_cap:
        # Caller-sized buffer smaller than the chunk's claimed num_values
        # (ragged rows vs a uniform-dim preallocation): clamp so the native
        # capacity check returns ERR_CAPACITY instead of writing past the
        # buffer; the FormatError routes callers to the pyarrow fallback,
        # which raises the canonical ragged-row error.
        value_cap = values.size
    row_lengths = np.empty(row_cap, dtype=np.int64)
    num_values = ctypes.c_int64(0)
    rc = lib.pqv_decode_chunk(
        buf,
        len(buf),
        codec.encode(),
        ptype,
        max_def,
        max_rep,
        values.ctypes.data_as(ctypes.c_void_p),
        value_cap,
        row_lengths.ctypes.data_as(ctypes.c_void_p),
        row_cap,
        ctypes.byref(num_values),
    )
    if rc < 0:
        raise FormatError(_ERRORS.get(rc, f"native chunk decode error {rc}"))
    return values[: num_values.value], row_lengths[:rc]


def decode_pages_native(
    buf: bytes,
    offsets,
    lens,
    codec: str,
    ptype: int,
    max_def: int,
    max_rep: int,
    row_cap: int,
    value_cap: int,
):
    """Batched page decode: one FFI call for all selected pages of a span.

    Returns ``(values f32 [nv], row_lengths i64 [nr], page_value_start
    [n_pages+1], page_row_start [n_pages+1])`` or None when the library is
    unavailable. Raises FormatError on decode errors (caller falls back to
    the per-page Python decoder).
    """
    import numpy as np

    lib = load()
    if lib is None:
        return None
    if not isinstance(buf, bytes):
        # Zero-copy pass-through for bytearray/memoryview page buffers
        # (c_char arrays are accepted where c_char_p is declared).
        buf = (ctypes.c_char * len(buf)).from_buffer(buf)
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    lens = np.ascontiguousarray(lens, dtype=np.uint64)
    n_pages = offsets.size
    values = np.empty(value_cap, dtype=np.float32)
    row_lengths = np.empty(row_cap, dtype=np.int64)
    pvs = np.empty(n_pages + 1, dtype=np.int64)
    prs = np.empty(n_pages + 1, dtype=np.int64)
    rc = lib.pqv_decode_pages(
        buf,
        len(buf),
        offsets.ctypes.data,
        lens.ctypes.data,
        n_pages,
        codec.encode(),
        ptype,
        max_def,
        max_rep,
        values.ctypes.data,
        value_cap,
        row_lengths.ctypes.data,
        row_cap,
        pvs.ctypes.data,
        prs.ctypes.data,
    )
    if rc < 0:
        raise FormatError(_ERRORS.get(rc, f"native page decode error {rc}"))
    return values[: pvs[n_pages]], row_lengths[:rc], pvs, prs


if __name__ == "__main__":
    import sys

    if "--build" in sys.argv:
        ok = ensure_built(force=True)
        print("built" if ok else "build failed")
        sys.exit(0 if ok else 1)
    lib = load()
    print(lib.pqv_version().decode() if lib else "native library unavailable")
