"""Launch geometry of the score tile shared by K9, K5, K2 and K1.

``csrc/score_tile.cuh`` scores up to 128 queries against 128-row chunks in
registers, on one of two back ends: ``"fma"``, IEEE fp32 on the CUDA cores
(f32 storage always; bf16 storage widened where the tensor cores cannot take
it), and ``"wgmma"``, bf16 x bf16 with fp32 accumulation on the tensor cores.
The only switch between them is ``pick_backend``, a rule on dtype, width and
addresses decided before any launch. The functions below mirror the
constants of the CUDA sources so that the shapes, the grid and the dynamic
shared memory of a launch can be reckoned, and tested, without a card.
"""

from __future__ import annotations

import torch

THREADS = 256  # threads of a block
CHUNK_ROWS = 128  # rows whose sums a block holds in registers at a time
SMEM_LIMIT = 232_448  # dynamic shared memory a block can opt into on sm_90
_ALIGN_SLACK = 1024  # the ring is aligned to the swizzle's 1024 bytes by hand
_NORMS = 2 * CHUNK_ROWS * 4  # the norms of this chunk and the next
DUMP_STRIDE = 65  # floats per query of the 64-row score dump of K5 and K2
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
    return 64 if backend == "fma" and batch <= 64 else 128


def stage_bytes(backend: str, queries: int) -> int:
    """One stage of the ring: 64 dimensions of 128 queries and 128 rows in
    bf16, or 16 dimensions of the queries and rows in f32, transposed with
    a 4-float pad per dimension."""
    if backend == "wgmma":
        return 2 * 128 * 128
    return 16 * ((CHUNK_ROWS + 4) + (queries + 4)) * 4


def stages(kernel: str, backend: str) -> int:
    """Stages in the ring: 3, but 2 for K5 and K2 on wgmma so that 128 lists
    of k = 128 still fit beside them."""
    return 2 if kernel in ("K5", "K2") and backend == "wgmma" else 3


def smem_bytes(kernel: str, backend: str, queries: int, k: int = 0) -> int:
    """Dynamic shared memory of a launch of ``kernel`` ("K9", "K5", "K2" or
    "K1"): the ring and the norms; for K5 and K2 the lists ([k][queries] f32
    + i32) and the score dump, for K9 one carried minimum per query; K1's
    running argmin lives in registers."""
    total = _ALIGN_SLACK + stages(kernel, backend) * stage_bytes(backend, queries) + _NORMS
    if kernel in ("K5", "K2"):
        return total + queries * (8 * k + 4 * DUMP_STRIDE)
    if kernel == "K9":
        return total + 128 * 4  # a long tile's minimum so far, per query
    return total


def wave_blocks(smem: int) -> int:
    """Blocks of one wave of a launch whose blocks take ``smem`` bytes of
    dynamic shared memory: two on each SM (256 threads at up to 128
    registers), one where two do not fit its shared memory."""
    return SM_COUNT * max(1, min(2, SMEM_PER_SM // (smem + 1024)))


def grid_blocks(batch: int, backend: str, units: int) -> int:
    """Blocks of a launch over ``units`` row runs (K9, K2) or tiles (K5): the
    query groups of one unit are neighbours, so the later ones find the rows
    in L2."""
    q = block_queries(batch, backend)
    return units * (-(-batch // q))

