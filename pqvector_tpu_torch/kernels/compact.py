"""K10 and K11: gather of selected row tiles into one contiguous block.

Counterpart of ``pqvector_tpu/kernels/compact.py``: ``pallas_tile_gather``
(K10, the copy staged through fast memory) and ``pallas_tile_gather_dma``
(K11, direct asynchronous copies, eight in flight). Both return
``(emb[sel] as [cap * ctile, d], emb_sq[sel] as [cap * ctile])``, bit for
bit; ``sel`` may repeat tiles and need not be sorted. On CUDA tensors they
launch the hand-written kernels of ``csrc/compact.cu``; on CPU tensors they
run ``tile_gather_plain``.

Both kernels copy the same items, cut in ``csrc/compact.cu``: each array's
tiles in items of at most 16 KB, a tile larger than that into slices and
smaller tiles several whole to an item. K10 runs a block an item; K11 a ring
of stages an SM that walks them.
"""

from __future__ import annotations

import torch

from . import _build
from .scan_topk import check_cuda_operands


def _check_args(emb, emb_sq, sel, ctile: int) -> None:
    if emb.dim() != 2 or emb.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("emb is float32 or bfloat16 [n_pad, d]")
    if emb_sq.dtype != torch.float32 or emb_sq.shape != (emb.shape[0],):
        raise TypeError("emb_sq must be float32 [n_pad]")
    if sel.dtype != torch.int32 or sel.dim() != 1 or sel.numel() == 0:
        raise TypeError("sel must be a non-empty int32 vector of tile ids")
    if ctile <= 0 or emb.shape[0] % ctile:
        raise ValueError(f"n_pad {emb.shape[0]} is not a multiple of ctile {ctile}")
    if len({t.device for t in (emb, emb_sq, sel)}) != 1:
        raise ValueError("all operands must be on one device")


def tile_gather_plain(emb, emb_sq, sel, ctile: int):
    """The gather in plain torch."""
    n_pad, d = emb.shape
    nt = n_pad // ctile
    idx = sel.long()
    emb_c = emb.view(nt, ctile, d)[idx].reshape(-1, d)
    return emb_c, emb_sq.view(nt, ctile)[idx].reshape(-1)


def _word(nbytes: int, *tensors) -> int:
    """The widest of 16, 4 and 2 bytes dividing ``nbytes`` and every
    tensor's address."""
    for w in (16, 4):
        if nbytes % w == 0 and all(t.data_ptr() % w == 0 for t in tensors):
            return w
    return 2


def _outputs(emb, emb_sq, sel, ctile):
    cap = sel.numel()
    return (
        torch.empty((cap * ctile, emb.shape[1]), dtype=emb.dtype, device=emb.device),
        torch.empty(cap * ctile, dtype=torch.float32, device=emb.device),
    )


def tile_gather(emb, emb_sq, sel, ctile: int):
    """K10: gather ``cap = len(sel)`` tiles of ``ctile`` rows and their norms
    -> ``(emb_c [cap * ctile, d], sq_c [cap * ctile])``.

    ``emb`` [n_pad, d] f32 or bf16, ``emb_sq`` [n_pad] f32, ``sel`` [cap]
    int32 tile ids in [0, n_pad / ctile). Any ``ctile`` dividing ``n_pad``
    goes through the kernel: a block copies each item of up to 16 KB, each
    thread holding four loads before it stores; it copies 16-byte words
    where a tile's bytes and the addresses allow, 4- or 2-byte words
    otherwise."""
    _check_args(emb, emb_sq, sel, ctile)
    if emb.device.type == "cpu":
        return tile_gather_plain(emb, emb_sq, sel, ctile)
    check_cuda_operands(emb=emb, emb_sq=emb_sq, sel=sel)
    lib = _build.load()
    emb_c, sq_c = _outputs(emb, emb_sq, sel, ctile)
    seg = ctile * emb.shape[1] * emb.element_size()
    seg_sq = ctile * 4
    rc = lib.pqv_tile_gather(
        emb.data_ptr(), emb_sq.data_ptr(), sel.data_ptr(), emb_c.data_ptr(),
        sq_c.data_ptr(), sel.numel(), seg, seg_sq, _word(seg, emb, emb_c),
        _word(seg_sq, emb_sq, sq_c), _build.stream_ptr(),
    )
    _build.check(rc, "pqv_tile_gather")
    _build.LAUNCHES["K10"] += 1
    return emb_c, sq_c


def dma_eligible(emb, emb_sq, ctile: int) -> bool:
    """Whether K11's bulk copies take these arrays: a tile's bytes in both
    arrays and both addresses are multiples of 16."""
    seg = ctile * emb.shape[1] * emb.element_size()
    return _word(seg, emb) == 16 and _word(ctile * 4, emb_sq) == 16


def tile_gather_dma(emb, emb_sq, sel, ctile: int):
    """K11: the gather of ``tile_gather`` through the card's asynchronous
    copy engine (bulk copies device memory -> shared memory -> device memory
    on a ring of eight 16 KB stages a block, one block an SM, loads from a
    producer warp and stores from a consumer lane; no thread touches the
    data).

    The engine moves multiples of 16 bytes between addresses that are
    multiples of 16. Where a tile's bytes in ``emb`` or in ``emb_sq``
    (``ctile * 4``), or an array's address, are not (``dma_eligible`` is
    false), this call takes K10 instead: a rule on shapes, decided before
    any launch."""
    _check_args(emb, emb_sq, sel, ctile)
    if emb.device.type == "cpu":
        return tile_gather_plain(emb, emb_sq, sel, ctile)
    if not dma_eligible(emb, emb_sq, ctile):
        return tile_gather(emb, emb_sq, sel, ctile)
    check_cuda_operands(emb=emb, emb_sq=emb_sq, sel=sel)
    lib = _build.load()
    emb_c, sq_c = _outputs(emb, emb_sq, sel, ctile)
    seg = ctile * emb.shape[1] * emb.element_size()
    seg_sq = ctile * 4
    rc = lib.pqv_tile_gather_dma(
        emb.data_ptr(), emb_sq.data_ptr(), sel.data_ptr(), emb_c.data_ptr(),
        sq_c.data_ptr(), sel.numel(), seg, seg_sq, _build.stream_ptr(),
    )
    _build.check(rc, "pqv_tile_gather_dma")
    _build.LAUNCHES["K11"] += 1
    return emb_c, sq_c
