"""IVF index construction on a torch device.

Counterpart of ``pqvector_tpu/index/build.py``: ``build_ivf_index``
(pq-vector src/ivf/index.rs:152-214: default ``n_clusters = ceil(sqrt n)``,
5%/100k training sample, k-means on the sample, then one full-data
assignment pass, K1 on CUDA, to build the inverted lists) and
``build_ivf_index_staged``, the same build fed row group by row group from
a Parquet file: several decode at once into pinned memory while those
before them are copied to the card.

``transfer_dtype`` picks the dtype the rows take on their way to the
device: "float32" (what "auto" is here and in the JAX package off the TPU),
"bfloat16" (each element rounded to nearest even) or "int8" (symmetric
per-row codes and an f32 scale). The rounding is the build's input: the
index is that of the rounded rows, the same bytes as the JAX package's
under the same option. The resident matrix stays in the wire dtype (bf16:
K1 reads it in its bf16-row form, half the device memory of f32).
``assign_backend="host"`` ships only the training sample, trains on the
device and runs the full assignment on the host (a BLAS sgemm, or a
certified bf16 matmul where the host has AMX-BF16, and a native argmin).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os

import numpy as np
import torch

from .._device import resolve_device
from ..errors import FormatError, ValidationError
from ..kernels.assign import screen_counts
from ..types import Embeddings
from .ivf import IvfIndex
from .kmeans import (
    KMeansParams,
    assign_clusters,
    default_n_clusters,
    k_means,
    sample_indices_host,
    train_sample_size,
)


@dataclasses.dataclass(frozen=True)
class IvfBuildConfig:
    """Mirror of IvfBuildConfig (pq-vector src/ivf/index.rs:46-50).

    ``transfer_dtype`` ("auto" | "float32" | "bfloat16" | "int8") and
    ``assign_backend`` ("auto" | "device" | "host") keep the JAX package's
    names, checks and "auto" off the TPU: "float32" and "device". Like the
    JAX package's in-memory build, ``build_ivf_index`` ignores
    ``assign_backend``."""

    n_clusters: int | None = None
    max_iters: int = 20
    seed: int = 42
    block_rows: int = 8192
    transfer_dtype: str = "auto"
    assign_backend: str = "auto"

    def __post_init__(self) -> None:
        if self.max_iters <= 0:
            raise ValidationError("max_iters must be > 0")
        if self.n_clusters is not None and self.n_clusters <= 0:
            raise ValidationError("n_clusters must be > 0")
        if self.transfer_dtype not in ("auto", "float32", "bfloat16", "int8"):
            raise ValidationError(
                "transfer_dtype must be 'auto', 'float32', 'bfloat16' "
                "or 'int8'"
            )
        if self.assign_backend not in ("auto", "device", "host"):
            raise ValidationError(
                "assign_backend must be 'auto', 'device' or 'host'"
            )


def resolve_transfer_dtype(config: IvfBuildConfig) -> str:
    """"auto" is float32 (the JAX package's rule off the TPU); the others
    pass through."""
    return "float32" if config.transfer_dtype == "auto" else config.transfer_dtype


def resolve_assign_backend(config: IvfBuildConfig) -> str:
    """"auto" is device (the JAX package's rule off the TPU); "host" passes
    through."""
    return "device" if config.assign_backend == "auto" else config.assign_backend


_HOST_AMX_BF16: bool | None = None


def _host_amx_bf16() -> bool:
    """Whether the host CPU advertises AMX-BF16, on which torch's CPU
    matmul (oneDNN) runs bf16 products on the tile units."""
    global _HOST_AMX_BF16
    if _HOST_AMX_BF16 is None:
        try:
            with open("/proc/cpuinfo") as f:
                _HOST_AMX_BF16 = "amx_bf16" in f.read()
        except OSError:
            _HOST_AMX_BF16 = False
    return _HOST_AMX_BF16


def resolve_host_gemm(wire_mode: str) -> str:
    """The host assignment's GEMM: "bf16" (certified, see
    ``_assign_clusters_host``: its partition equals the f32 sgemm's) where
    the host has AMX-BF16 and the build is already on a lossy wire, else
    "f32". ``PQVECTOR_TPU_HOST_GEMM=bf16|f32`` overrides both."""
    env = os.environ.get("PQVECTOR_TPU_HOST_GEMM", "auto")
    if env in ("bf16", "f32"):
        return env
    lossy = wire_mode in ("bfloat16", "int8")
    return "bf16" if (lossy and _host_amx_bf16()) else "f32"


def _argmin_host(lib, scores: np.ndarray, bias: np.ndarray, out: np.ndarray) -> None:
    """out = first argmin over columns of ``bias - 2 scores``: the native
    pass where the library is loaded, numpy where it is not or declines."""
    import ctypes

    if lib is not None:
        rc = lib.pqv_assign_argmin(
            scores.ctypes.data_as(ctypes.c_void_p), scores.shape[0], scores.shape[1],
            bias.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc == 0:
            return
    out[:] = np.argmin(bias - 2.0 * scores, axis=1)


def _assign_clusters_host(
    parts: list[np.ndarray],
    centroids: np.ndarray,
    block_rows: int = 65536,
    normalize: bool = False,
    gemm: str = "f32",
) -> np.ndarray:
    """Nearest-centroid ids on the host, over the reduced form
    ``|c_j|^2 - 2 x.c_j`` with the first minimum, as K1. ``parts`` are the
    decoded chunks, never concatenated.

    ``gemm="f32"``: a BLAS sgemm a block and the native argmin.
    ``gemm="bf16"``: the scores of a block in one bf16 matmul on torch's
    CPU backend (AMX where the host has it), then every row whose top-2
    margin lies within the bf16 error envelope, ``2 * 2^-5 * |x| * max|c|``
    (at least 3x the bound ``2 (2^-8 + 2^-9) |x| |c_j|`` of a reduced score),
    is scored again by the exact f32 sgemm: the partition equals the f32
    path's. The same numbers as the JAX package's function on the same
    parts, bit for bit."""
    import ctypes

    from ..io.native import load as _native_load

    c = np.ascontiguousarray(centroids, dtype=np.float32)
    ct = c.T.copy()  # [d, k] contiguous for sgemm
    bias = (c * c).sum(axis=1).astype(np.float32)  # |c_j|^2
    k = c.shape[0]
    cmax = float(np.sqrt(bias.max())) if k else 0.0
    torch_w = torch.from_numpy(ct).bfloat16() if gemm == "bf16" else None
    lib = _native_load()
    if lib is not None and not hasattr(lib, "pqv_assign_argmin"):
        lib = None
    margin = lib is not None and hasattr(lib, "pqv_assign_margin_bf16")
    out_parts = []
    for part in parts:
        part = np.ascontiguousarray(part, dtype=np.float32)
        n = part.shape[0]
        assign = np.empty(n, np.int32)
        for lo in range(0, n, block_rows):
            hi = min(lo + block_rows, n)
            blockv = part[lo:hi]
            if normalize:
                norms = np.sqrt((blockv * blockv).sum(axis=1, keepdims=True))
                blockv = blockv / np.maximum(norms, np.float32(1e-30))
            if torch_w is None:
                _argmin_host(lib, blockv @ ct, bias, assign[lo:hi])
                continue
            blockv = np.ascontiguousarray(blockv)
            sb = torch.from_numpy(blockv).bfloat16() @ torch_w  # [b, k] bf16 scores
            xn = np.sqrt(np.einsum("nd,nd->n", blockv, blockv))
            env = np.ascontiguousarray(np.float32(2.0 * 2.0**-5 * cmax) * xn)
            idx = amb = None
            if margin:
                su = sb.view(torch.int16).numpy()  # the bf16 bits, no copy
                idx = np.empty(hi - lo, np.int32)
                ambu = np.empty(hi - lo, np.uint8)
                rc = lib.pqv_assign_margin_bf16(
                    su.ctypes.data_as(ctypes.c_void_p), hi - lo, k,
                    bias.ctypes.data_as(ctypes.c_void_p),
                    env.ctypes.data_as(ctypes.c_void_p),
                    idx.ctypes.data_as(ctypes.c_void_p),
                    ambu.ctypes.data_as(ctypes.c_void_p),
                )
                if rc == 0:
                    amb = ambu.astype(bool)
                else:
                    idx = None
            if idx is None:  # numpy margins (no native library)
                red = sb.float().numpy()
                red *= np.float32(-2.0)
                red += bias[None, :]
                rn = np.arange(hi - lo)
                idx = np.argmin(red, axis=1).astype(np.int32)
                m1 = red[rn, idx]
                red[rn, idx] = np.inf
                m2 = red.min(axis=1)
                amb = (m2 - m1) <= env
            if amb.any():
                sub_assign = np.empty(int(amb.sum()), np.int32)
                _argmin_host(lib, blockv[amb] @ ct, bias, sub_assign)  # exact f32
                idx[amb] = sub_assign
            assign[lo:hi] = idx
        out_parts.append(assign)
    return np.concatenate(out_parts) if len(out_parts) > 1 else out_parts[0]


def _encode_int8_np(part: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Numpy oracle of the symmetric per-row int8 wire: scale max|x| / 127
    (1 for a zero row), codes ``clip(rint(x / scale), -127, 127)``.
    Row-local, so a chunk's codes are its rows' codes in the whole matrix."""
    a = np.max(np.abs(part), axis=1)
    s = np.where(a > 0, a / 127.0, 1.0).astype(np.float32)
    codes = np.clip(np.rint(part / s[:, None]), -127, 127).astype(np.int8)
    return codes, s


def _cast_bf16_np(part: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bits (uint16), round to nearest even, NaN quieted with
    its sign kept: what ``ml_dtypes`` and the native cast give, in integer
    arithmetic (a CPU's own bf16 convert may flush subnormals)."""
    u = np.ascontiguousarray(part, dtype=np.float32).view(np.uint32)
    out = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16).astype(np.uint16)
    nan = np.isnan(part)
    if nan.any():
        out[nan] = np.where(np.signbit(part[nan]), 0xFFC0, 0x7FC0).astype(np.uint16)
    return out


def _check_out(out: np.ndarray, shape, dtype) -> None:
    """A destination the native encoders may write through a pointer."""
    if out.shape != tuple(shape) or out.dtype != dtype or not out.flags.c_contiguous:
        raise ValueError(f"output must be a contiguous {np.dtype(dtype)} array of shape "
                         f"{tuple(shape)}, got {out.dtype} {out.shape}")


def _cast_bf16(part: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """f32 -> bf16 as uint16 bits, into ``out`` where given: the native
    cast (round to nearest even, the GIL released), ``_cast_bf16_np`` where
    the library is absent or declines. The bits of the JAX package's
    ``_cast_bf16``."""
    import ctypes

    from ..io.native import load as _native_load

    part = np.ascontiguousarray(part, dtype=np.float32)
    if out is None:
        out = np.empty(part.shape, np.uint16)
    _check_out(out, part.shape, np.uint16)
    lib = _native_load()
    if lib is not None and hasattr(lib, "pqv_cast_bf16"):
        rc = lib.pqv_cast_bf16(part.ctypes.data_as(ctypes.c_void_p), part.size,
                               out.ctypes.data_as(ctypes.c_void_p))
        if rc == 0:
            return out
    out[...] = _cast_bf16_np(part)
    return out


def _encode_int8(
    part: np.ndarray, codes: np.ndarray | None = None, scales: np.ndarray | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """The int8 wire, into ``codes`` and ``scales`` where given: the native
    quantizer (the GIL released), the numpy oracle where the library is
    absent or declines. Bit-identical to ``_encode_int8_np``."""
    import ctypes

    from ..io.native import load as _native_load

    part = np.ascontiguousarray(part, dtype=np.float32)
    n, d = part.shape
    codes = np.empty((n, d), np.int8) if codes is None else codes
    scales = np.empty(n, np.float32) if scales is None else scales
    _check_out(codes, (n, d), np.int8)
    _check_out(scales, (n,), np.float32)
    lib = _native_load()
    if lib is not None and hasattr(lib, "pqv_quantize_i8"):
        rc = lib.pqv_quantize_i8(part.ctypes.data_as(ctypes.c_void_p), n, d,
                                 codes.ctypes.data_as(ctypes.c_void_p),
                                 scales.ctypes.data_as(ctypes.c_void_p))
        if rc == 0:
            return codes, scales
    codes[...], scales[...] = _encode_int8_np(part)
    return codes, scales


def _dequant_i8(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """int8 codes [n, d] x per-row scale -> f32 [n, d]: one f32 rounding an
    element, so the same bits on any device and in the JAX package. The
    product is taken in place: one f32 matrix, not two."""
    return codes.float().mul_(scales[:, None])


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """uint16 bf16 bits -> a bf16 CPU tensor over the same memory."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(torch.bfloat16)


def _wire_rows(data: np.ndarray, wire: str, device: torch.device) -> torch.Tensor:
    """Rows as the wire delivers them to ``device``: f32, bf16 (kept in
    bf16), or int8 codes dequantized there to f32."""
    if wire == "bfloat16":
        return _bf16_tensor(_cast_bf16(data)).to(device)
    if wire == "int8":
        codes, scales = _encode_int8(data)
        return _dequant_i8(torch.from_numpy(codes).to(device),
                           torch.from_numpy(scales).to(device))
    return torch.from_numpy(np.require(data, np.float32, ["C", "W"])).to(device)


def _train_params(config: IvfBuildConfig, n: int) -> tuple[KMeansParams, int]:
    """The k-means parameters and the training-sample size of a build over
    ``n`` rows: ``n_clusters`` defaults to ``ceil(sqrt n)``."""
    n_clusters = (
        config.n_clusters if config.n_clusters is not None else default_n_clusters(n)
    )
    if n_clusters > n:
        raise ValidationError("n_clusters cannot exceed number of vectors")
    params = KMeansParams(
        n_clusters=n_clusters,
        max_iters=config.max_iters,
        seed=config.seed,
        block_rows=config.block_rows,
    )
    return params, train_sample_size(n, n_clusters)


def build_ivf_index(
    embeddings: Embeddings,
    config: IvfBuildConfig | None = None,
    device: str | torch.device | None = None,
) -> IvfIndex:
    """Train and assign on ``device``; the result is deterministic per seed.
    Under a reduced wire the rows are encoded on the host (the training
    sample from its own rows, as the JAX package does) and the index is
    that of the rounded rows."""
    from ..utils.profiling import stage

    device = resolve_device(device)
    config = config or IvfBuildConfig()
    n = embeddings.row_count
    if n == 0:
        raise ValidationError("Cannot build IVF index with zero vectors")
    params, sample_size = _train_params(config, n)
    wire = resolve_transfer_dtype(config)
    # writable and contiguous: pyarrow's zero-copy arrays are read-only
    data = np.require(embeddings.data, np.float32, ["C", "W"])
    if sample_size == n:
        with stage("build.transfer"):
            x = _wire_rows(data, wire, device).float()
        with stage("build.train"):
            centroids, _ = k_means(x, params, device=device)
    else:
        # The same host draw as the JAX package (pq-vector
        # src/ivf/index.rs:222-242): both train on the same rows.
        idx = sample_indices_host(config.seed ^ 0x5A5A5A5A, n, sample_size)
        with stage("build.sample_transfer"):
            sample = _wire_rows(data[idx], wire, device).float()
        with stage("build.transfer"):
            x = _wire_rows(data, wire, device)  # bf16 stays bf16: K1 reads it
        with stage("build.train"):
            centroids, _ = k_means(sample, params, device=device)
    # Like the reference, always a fresh full-data pass (:193-206).
    with stage("build.assign", counters=screen_counts):
        assignments = assign_clusters(x, centroids, device=device)
    return IvfIndex.from_assignments(centroids, assignments)


#: Pinned host memory the staged build's decode slots may take.
_PINNED_BUDGET = 512 << 20

#: The dtype each wire's rows take on the device (int8: the codes).
_WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _upload_chunks(chunks, device: torch.device, wire: str = "float32") -> torch.Tensor:
    """Concatenate decoded [rows, d] f32 chunks, each wire-encoded, into one
    [n, d] tensor on ``device`` (the CPU form, and layouts the native
    decoder declines): f32, bf16, or int8 codes dequantized on ``device``."""
    rows, scales = [], []
    for c in chunks:
        c = np.require(c, np.float32, ["C", "W"])
        if rows and c.shape[1] != rows[0].shape[1]:
            raise ValidationError("Inconsistent embedding dimensions")
        if wire == "bfloat16":
            rows.append(_bf16_tensor(_cast_bf16(c)))
        elif wire == "int8":
            codes, s = _encode_int8(c)
            rows.append(torch.from_numpy(codes))
            scales.append(torch.from_numpy(s))
        else:
            rows.append(torch.from_numpy(c))
    if not rows:
        raise ValidationError("Cannot build IVF index with zero vectors")
    x = (torch.cat(rows) if len(rows) > 1 else rows[0]).to(device)
    if wire != "int8":
        return x
    return _dequant_i8(x, (torch.cat(scales) if len(scales) > 1 else scales[0]).to(device))


def _upload_column(path, embedding_column, batch_rows: int,
                   device: torch.device, wire: str = "float32") -> torch.Tensor:
    """The embedding column as one [n, d] tensor on ``device`` as the wire
    delivers it: f32, bf16, or int8 codes (and their scales) dequantized
    there once to f32.

    On the card the row groups decode in parallel (``io/pages.
    decode_row_groups``, a slot a worker), and each is copied to the device
    with ``non_blocking`` on a side stream once it and the row groups before
    it are decoded; a worker waits for its slot's last copy before filling
    it again. So the decode of the next row groups overlaps the copy of this
    one. Under the f32 wire a worker decodes straight into its pinned slot;
    under a reduced wire it decodes into a host buffer of its own and
    encodes from there into its pinned slot (the native encoders release
    the GIL), so the slots, and what crosses the bus, are half (bf16) or a
    quarter plus the scales (int8) of the f32 bytes. The rows are the
    decoded bytes, encoded: the tensor equals a read, encode, then upload."""
    from ..io.pages import (
        DECODE_WORKERS,
        decode_row_groups,
        embedding_dim_hint,
        embedding_leaf_meta,
    )
    from ..utils import profiling
    from .streaming import iter_embedding_batches

    lm = None
    if device.type == "cuda":
        try:
            lm = embedding_leaf_meta(path, embedding_column)
        except FormatError:
            lm = None
    dim = None
    if lm is not None and lm[2]:
        leaf_idx, leaf, rgs = lm
        dim = embedding_dim_hint(rgs[0], leaf_idx)
    if dim is None:
        return _upload_chunks(
            iter_embedding_batches(path, embedding_column, batch_rows), device, wire
        )
    n = sum(rg.num_rows for rg in rgs)
    cap = max(rg.num_rows for rg in rgs)
    dtype = _WIRE_DTYPES[wire]
    slot_bytes = cap * dim * dtype.itemsize + (cap * 4 if wire == "int8" else 0)
    workers = max(1, min(DECODE_WORKERS, _PINNED_BUDGET // max(1, slot_bytes)))
    x = torch.empty((n, dim), dtype=dtype, device=device)
    xs = torch.empty(n, dtype=torch.float32, device=device) if wire == "int8" else None
    slots = [torch.empty((cap, dim), dtype=dtype, pin_memory=True) for _ in range(workers)]
    sslots = [torch.empty(cap, dtype=torch.float32, pin_memory=True)
              for _ in range(workers if wire == "int8" else 0)]
    done: list = [None] * workers
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))  # x may reuse freed memory

    def wait_slot(i):  # on a worker: wait for the slot's last copy
        if done[i % workers] is not None:
            done[i % workers].synchronize()

    def slot(i):  # f32: lend the pinned slot itself
        wait_slot(i)
        return slots[i % workers][: rgs[i].num_rows].numpy()

    scratch = [None] * workers

    def scratch_of(i):  # reduced wire: decode into the worker's own f32 buffer
        if scratch[i % workers] is None:
            scratch[i % workers] = np.empty((cap, dim), np.float32)
        return scratch[i % workers][: rgs[i].num_rows]

    def encode(i, part):  # reduced wire, on the worker: encode into the slot
        wait_slot(i)
        rows = part.shape[0]
        if wire == "bfloat16":
            _cast_bf16(part, out=slots[i % workers][:rows].view(torch.int16).numpy()
                       .view(np.uint16))
        else:
            _encode_int8(part, codes=slots[i % workers][:rows].numpy(),
                         scales=sslots[i % workers][:rows].numpy())
        return part

    parent = profiling.current()

    def decode_span():  # on a worker: one a row group, under the caller's stage
        return profiling.stage("build.decode", parent=parent, drain=False)

    row = 0
    if wire == "float32":
        chunks = decode_row_groups(path, rgs, leaf_idx, leaf, out=slot, workers=workers,
                                   column=embedding_column, span=decode_span)
    else:
        chunks = decode_row_groups(path, rgs, leaf_idx, leaf, out=scratch_of,
                                   workers=workers, column=embedding_column, post=encode,
                                   span=decode_span)
    with contextlib.closing(chunks):
        for i, _ in enumerate(chunks):  # row group i is in its slot
            rows = rgs[i].num_rows
            with torch.cuda.stream(stream):
                x[row : row + rows].copy_(slots[i % workers][:rows], non_blocking=True)
                if xs is not None:
                    xs[row : row + rows].copy_(sslots[i % workers][:rows],
                                               non_blocking=True)
                done[i % workers] = torch.cuda.Event()
                done[i % workers].record(stream)
            row += rows
    torch.cuda.current_stream(device).wait_stream(stream)
    return x if xs is None else _dequant_i8(x, xs)


def build_ivf_index_staged(
    path: str | os.PathLike,
    embedding_column,
    config: IvfBuildConfig | None = None,
    batch_rows: int = 131072,
    normalize: bool = False,
    device: str | torch.device | None = None,
) -> IvfIndex:
    """In-place build fed from the file: the native chunk decoder
    decodes the row groups in parallel into pinned slots, each copied to
    ``device`` while the next decode (``_upload_column``), then training
    and the full assignment run on the assembled matrix.

    Same deterministic result as ``build_ivf_index`` on the decoded rows:
    the wire encoders are row-local, the training sample is gathered on the
    device at the same host-drawn indices (from the wire-dtype matrix, then
    widened), and the cosine normalization (``normalize``) is row-local f32
    on the device: ``x / max(sqrt(sum(x * x)), 1e-30)``. The resident matrix
    stays in the wire dtype (int8 is dequantized once); K1 reads bf16 rows
    as they are, unless ``normalize`` widens the matrix first, as the JAX
    package does. ``assign_backend="host"``: see
    ``_build_staged_host_assign``."""
    from ..utils.profiling import stage

    device = resolve_device(device)
    config = config or IvfBuildConfig()
    wire = resolve_transfer_dtype(config)
    backend = resolve_assign_backend(config)
    # The pair decides the partition (the host pass reads the decoded f32
    # rows, the device pass the wire-rounded ones): logged so that two
    # environments' partitions can be told apart.
    logging.getLogger("pqvector_tpu_torch.build").info(
        "staged build: transfer_dtype=%s assign_backend=%s host_gemm=%s backend=%s",
        wire, backend, resolve_host_gemm(wire) if backend == "host" else "-",
        device.type,
    )
    if backend == "host":
        return _build_staged_host_assign(path, embedding_column, config, batch_rows,
                                         normalize, wire, device)
    with stage("build.decode+transfer"):
        x = _upload_column(path, embedding_column, batch_rows, device, wire)
    with stage("build.transfer_drain"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    n = x.shape[0]
    params, sample_size = _train_params(config, n)

    def upcast_norm(a):
        a = a.float()  # all training math is f32
        if normalize:
            norms = (a * a).sum(dim=1, keepdim=True).sqrt()
            a = a / norms.clamp_min(1e-30)
        return a

    with stage("build.train"):
        if sample_size == n:
            sample = upcast_norm(x)
        else:
            idx = sample_indices_host(config.seed ^ 0x5A5A5A5A, n, sample_size)
            sample = upcast_norm(x[torch.as_tensor(idx, device=x.device)])
        centroids, _ = k_means(sample, params, device=device)
    with stage("build.assign", counters=screen_counts):
        xa = upcast_norm(x) if normalize else x  # K1 reads bf16 rows itself
        assignments = assign_clusters(xa, centroids, device=device)
    return IvfIndex.from_assignments(centroids, assignments)


def _build_staged_host_assign(
    path,
    embedding_column,
    config: IvfBuildConfig,
    batch_rows: int,
    normalize: bool,
    wire: str,
    device: torch.device,
) -> IvfIndex:
    """Staged build, ``assign_backend="host"``: decode on the host, send
    only the training sample (wire-encoded from the decoded rows: the
    encoders are row-local, so the same values the device path gathers),
    widen and normalize it on ``device``, train there, bring the centroids
    back, and assign every decoded f32 row on the host
    (``_assign_clusters_host``, with ``resolve_host_gemm``). The centroids
    equal the device path's bit for bit; the ids read the exact decoded
    rows, not the wire-rounded ones."""
    from ..utils.profiling import stage
    from .streaming import iter_embedding_batches

    with stage("build.decode"):
        parts = []
        rows = 0
        dim = None
        for part in iter_embedding_batches(path, embedding_column, batch_rows):
            dim = part.shape[1] if dim is None else dim
            if part.shape[1] != dim:
                raise ValidationError("Inconsistent embedding dimensions")
            rows += len(part)
            parts.append(np.ascontiguousarray(part, dtype=np.float32))
        if rows == 0:
            raise ValidationError("Cannot build IVF index with zero vectors")

    n = rows
    params, sample_size = _train_params(config, n)

    with stage("build.sample_transfer"):
        if sample_size == n:
            sample_h = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
        else:
            # The host-drawn sample, gathered across chunk boundaries in
            # the order of ``idx`` (the device path's gather order).
            idx = sample_indices_host(config.seed ^ 0x5A5A5A5A, n, sample_size)
            starts = np.zeros(len(parts) + 1, np.int64)
            np.cumsum([len(p) for p in parts], out=starts[1:])
            cid = np.searchsorted(starts, idx, side="right") - 1
            sample_h = np.empty((len(idx), dim), np.float32)
            for j, p in enumerate(parts):
                m = cid == j
                if m.any():
                    sample_h[m] = p[idx[m] - starts[j]]
        sample = _wire_rows(sample_h, wire, device).float()
        if normalize:
            norms = (sample * sample).sum(dim=1, keepdim=True).sqrt()
            sample = sample / norms.clamp_min(1e-30)
    with stage("build.train"):
        centroids, _ = k_means(sample, params, device=device)  # numpy out
    with stage("build.assign"):
        assignments = _assign_clusters_host(
            parts, centroids, normalize=normalize, gemm=resolve_host_gemm(wire),
        )
    return IvfIndex.from_assignments(centroids, assignments)
