"""Launch geometry of the score tile shared by K9, K5, K4, K6, K2, K1, K7
and K8.

``csrc/score_tile.cuh`` scores up to 128 queries against 128-row chunks in
registers, on one of three back ends: ``"fma"``, IEEE fp32 on the CUDA cores
(f32 storage always; bf16 storage widened where the tensor cores cannot take
it), ``"wgmma"``, bf16 x bf16 with fp32 accumulation on the tensor cores, and
``"dp4a"``, K7's and K8's int8 codes with exact int32 sums on the CUDA cores
(``kernels/binscan.py:backend``). The switch between the first two is
``pick_backend``, a rule on dtype, width and addresses decided before any
launch. The functions below mirror the constants of the CUDA sources so that
the shapes, the grid and the dynamic shared memory of a launch can be
reckoned, and tested, without a card.
"""

from __future__ import annotations

import torch

THREADS = 256  # threads of a block
CHUNK_ROWS = 128  # rows whose sums a block holds in registers at a time
SMEM_LIMIT = 232_448  # dynamic shared memory a block can opt into on sm_90
_ALIGN_SLACK = 1024  # the ring is aligned to the swizzle's 1024 bytes by hand
_NORMS = 2 * CHUNK_ROWS * 4  # the norms of this chunk and the next
DUMP_STRIDE = 65  # floats per query of the 64-row score dump of K5 and K2
TABLE_WORDS_MAX = 8  # K4: probe tables of up to 256 slots live in shared memory
SEGMENT_CHUNKS = 32  # K4: chunks of a tile whose picks one 32-bit word holds
SM_COUNT = 132  # streaming multiprocessors of the H100
SMEM_PER_SM = 233_472  # shared memory of one; a resident block reserves 1 KB more


def pick_backend(dtype: torch.dtype, d: int, *addresses: int) -> str:
    """``"wgmma"`` for bf16 storage whose rows are 16-byte aligned (``d`` a
    multiple of 8, every array's address a multiple of 16: what the 16-byte
    copies into the swizzled stages need), else ``"fma"``."""
    if dtype == torch.bfloat16 and d % 8 == 0 and all(a % 16 == 0 for a in addresses):
        return "wgmma"
    return "fma"


def block_queries(batch: int, backend: str) -> int:
    """Queries one block owns: 128, or 64 on the CUDA cores for a batch of
    at most 64 (a warpgroup's wgmma has 64 query rows either way, and its
    unused rows cost no memory traffic)."""
    return 64 if backend in ("fma", "dp4a") and batch <= 64 else 128


def masked_block_queries(backend: str) -> int:
    """Queries one block of K4 or K6 owns: a warpgroup pair's 128 on
    wgmma, 64 on the CUDA cores whatever the batch. Fewer queries probe fewer of a
    tile's chunks, which pays where the products are the time, and two
    blocks fit an SM up to k = 100."""
    return 128 if backend == "wgmma" else 64


def stage_bytes(backend: str, queries: int) -> int:
    """One stage of the ring: 64 dimensions of 128 queries and 128 rows in
    bf16, or 16 dimensions (``"dp4a"``: 16 four-code words) of the queries
    and rows in 4-byte elements, transposed with a 4-element pad per
    dimension. K1's bf16-row forms: ``"screen"``, 64 dimensions of the 128
    queries and of three bf16 pieces of the 128 centroids; ``"fma_bf16"``,
    the ``"fma"`` stage and the queries' 16 dimensions raw in bf16. Its
    f32-row screen, ``"screen_f32"``: 64 dimensions of two bf16 pieces of
    the rows (staged raw in f32, split in place) and of the centroids."""
    if backend == "wgmma":
        return 2 * 128 * 128
    if backend in ("screen", "screen_f32"):
        return 4 * 128 * 128
    if backend == "fma_bf16":
        return stage_bytes("fma", queries) + queries * 16 * 2
    return 16 * ((CHUNK_ROWS + 4) + (queries + 4)) * 4


_LIST_KERNELS = ("K5", "K2", "K4", "K6")  # their epilogue keeps top-k lists


def stages(kernel: str, backend: str) -> int:
    """Stages in the ring: 3, but 2 for the list kernels on wgmma so that 128
    lists of k = 128 still fit beside them."""
    return 2 if kernel in _LIST_KERNELS and backend == "wgmma" else 3


def smem_bytes(kernel: str, backend: str, queries: int, k: int = 0, words: int = 0) -> int:
    """Dynamic shared memory of a launch of ``kernel`` ("K9", "K5", "K4", "K6",
    "K2", "K1", "K7" or "K8"): the ring and the norms; for K5, K4, K6 and K2
    the lists ([k][queries] f32 + i32) and the score dump, for K9 one
    carried minimum per query, for K7 and K8 the row scales of two chunks;
    K1's running argmin lives in registers (in shared memory between chunks
    for its bf16-row FMA form) and K7's bins too. K4 adds 64 bytes of flags
    and, with a probe table of ``words`` 32-bit words a query
    (``table_words``), the staged slots of two chunks, the slot sets of their
    quarters and the table; K6 with its table (``words`` = kc_pad / 32,
    a bit a cluster) the clusters of two chunks, two counts a query, the
    picks word, the union, the table and a byte a candidate's row, and
    without it what K4 takes without one."""
    total = _ALIGN_SLACK + stages(kernel, backend) * stage_bytes(backend, queries) + _NORMS
    if kernel in ("K7", "K8"):
        return total + _NORMS
    if kernel in _LIST_KERNELS:
        total += queries * (8 * k + 4 * DUMP_STRIDE)
        if kernel == "K6" and words:  # clusters, counts, picks, table, candidates' rows
            return total + _NORMS + queries * 8 + 16 + words * 4 + queries * words * 4 \
                + queries * 64
        if kernel in ("K4", "K6"):
            total += 64
            if words:
                total += 2 * CHUNK_ROWS * 4 + 2 * 4 * words * 4 + queries * words * 4
        return total
    if kernel == "K9":
        return total + 128 * 4  # a long tile's minimum so far, per query
    if kernel == "K1" and backend == "fma_bf16":
        return total + 2 * 8 * THREADS * 4  # each thread's 8 running (score, id)
    return total


def table_words(backend: str, queries: int, k: int, cmax: int) -> int:
    """Width of K4's probe table in shared memory, in 32-bit words a query:
    one bit per slot of a tile's cluster table (``cmax`` slots), or 0
    where that is wider than ``TABLE_WORDS_MAX`` words or does not fit beside
    the lists (k near 128 on wgmma). With 0 the same kernel reads the probe
    source from device memory and skips whole tiles only."""
    words = -(-cmax // 32)
    fits = smem_bytes("K4", backend, queries, k, words) <= SMEM_LIMIT
    return words if words <= TABLE_WORDS_MAX and fits else 0


def wave_blocks(smem: int) -> int:
    """Blocks of one wave of a launch whose blocks take ``smem`` bytes of
    dynamic shared memory: two on each SM (256 threads at up to 128
    registers), one where two do not fit its shared memory."""
    return SM_COUNT * max(1, min(2, SMEM_PER_SM // (smem + 1024)))


def grid_blocks(batch: int, backend: str, units: int) -> int:
    """Blocks of a launch over ``units`` row runs (K9, K2) or tiles (K5): the
    query groups of one unit are neighbours, so the later ones find the rows
    in L2. K4 (tiles) lays its grid out the same way, with
    ``masked_block_queries`` queries a group."""
    q = block_queries(batch, backend)
    return units * (-(-batch // q))

