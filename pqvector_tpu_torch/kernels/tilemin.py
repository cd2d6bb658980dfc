"""K9: per-tile minimum of ``|x|^2 - 2 q.x``, values only.

Counterpart of ``pqvector_tpu/kernels/tilemin.py`` (``pallas_tile_min``),
pass 1 of the certified-exact scan: the minimum over every contiguous
``tile``-row group, without the [B, n_pad] score block ever reaching device
memory. On CUDA tensors ``tile_min`` launches the hand-written kernel
(``csrc/tilemin.cu``, on the score tile of ``csrc/score_tile.cuh``: fp32 FMA
for f32 storage, wgmma for bf16 storage with ``d % 8 == 0``, by
``score_tile.pick_backend``); on CPU tensors it runs ``tile_min_plain``.

The score is the TPU kernel's: ``q2 = (-2 q)`` rounded to ``emb``'s dtype,
``dot(q2, x)`` accumulated in f32, then ``+ |x|^2``. Add ``|q|^2`` per query
for squared distances. A pad row (zeros, norm +3e38 or +inf) scores its
norm, so a tile of pad rows only returns the sentinel.
"""

from __future__ import annotations

import torch

from . import _build, score_tile
from .scan_topk import check_cuda_operands

#: Rows per step of the plain version: bounds its [B, rows] score block.
_PLAIN_ROWS = 65536
#: Rows one block of the kernel owns (a multiple of its 128-row chunk), unless
#: the tile is longer.
_RUN_ROWS = 1024


def _check_args(q, emb, emb_sq, tile: int) -> None:
    if q.dtype != torch.float32 or q.dim() != 2:
        raise TypeError("q must be float32 [B, d]")
    if emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("emb is float32 or bfloat16")
    if emb.dim() != 2 or emb.shape[1] != q.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, emb {tuple(emb.shape)}")
    if emb_sq.dtype != torch.float32 or emb_sq.shape != (emb.shape[0],):
        raise TypeError("emb_sq must be float32 [n_pad]")
    if tile < 2 or tile & (tile - 1) or emb.shape[0] % tile:
        raise ValueError(
            f"tile={tile} must be a power of two >= 2 dividing n_pad={emb.shape[0]}"
        )
    if len({t.device for t in (q, emb, emb_sq)}) != 1:
        raise ValueError("all operands must be on one device")


def tile_min_plain(q, emb, emb_sq, tile: int) -> torch.Tensor:
    """[B, n_pad / tile] f32 in plain torch (the matrix product sums in the
    library's order, the kernel in ascending dimension order)."""
    b = q.shape[0]
    n_pad = emb.shape[0]
    q2 = (-2.0 * q).to(emb.dtype).float()
    step = max(tile, _PLAIN_ROWS // tile * tile)
    out = torch.empty((b, n_pad // tile), dtype=torch.float32, device=emb.device)
    for lo in range(0, n_pad, step):
        hi = min(lo + step, n_pad)
        part = q2 @ emb[lo:hi].float().T + emb_sq[None, lo:hi]
        out[:, lo // tile : hi // tile] = part.view(b, -1, tile).amin(dim=2)
    return out


def tile_min(q, emb, emb_sq, tile: int, high: bool = False) -> torch.Tensor:
    """K9: [B, n_pad / tile] f32, the minimum of ``|x|^2 - 2 q.x`` over each
    contiguous ``tile``-row group.

    ``q`` [B, d] f32, ``emb`` [n_pad, d] f32 or bf16, ``emb_sq`` [n_pad] f32
    with +3e38 or +inf on pad rows, ``tile`` a power of two >= 2 dividing
    ``n_pad``. ``high`` asks the TPU kernel for a cheaper f32 product; the
    card's fp32 FMA is at least as accurate as either TPU setting, so it
    changes nothing here."""
    del high
    _check_args(q, emb, emb_sq, tile)
    if emb.device.type == "cpu":
        return tile_min_plain(q, emb, emb_sq, tile)
    q2 = (-2.0 * q).to(emb.dtype).contiguous()
    check_cuda_operands(q=q2, emb=emb, emb_sq=emb_sq)
    lib = _build.load()
    n_pad, d = emb.shape
    b = q.shape[0]
    out = torch.empty((b, n_pad // tile), dtype=torch.float32, device=emb.device)
    backend = score_tile.pick_backend(emb.dtype, d, q2.data_ptr(), emb.data_ptr())
    rc = lib.pqv_tile_min(
        q2.data_ptr(), emb.data_ptr(), emb_sq.data_ptr(), b, d, n_pad, tile,
        max(tile, _RUN_ROWS), int(emb.dtype == torch.bfloat16),
        int(backend == "wgmma"), out.data_ptr(), _build.stream_ptr(),
    )
    _build.check(rc, "pqv_tile_min")
    _build.LAUNCHES["K9"] += 1
    return out
