"""K7 and K8: the fused binned-min scan, over every row tile or over a list
of selected tiles.

Counterpart of ``pqvector_tpu/kernels/binscan.py``: the provenance budget
(``PROVENANCE_BITS_MAX``, ``provenance_split``, ``provenance_bits``), the
bin-geometry rule ``binscan_b_tile``, ``quantize_queries_i8``, ``_merge_bins``,
``pallas_binned_scan`` (K7, here ``binned_scan``) and
``pallas_binned_scan_select`` (K8, here ``binned_scan_select``). The key
tables come from the hand-written kernel ``csrc/binscan.cu`` on CUDA tensors
and from ``binned_scan_keys_plain``/``binned_scan_select_keys_plain`` on CPU
tensors. The query preparation, the cross-bin merge, the provenance decode
and the exact re-score are plain torch, as they are XLA code outside the
Pallas calls in the JAX package. The kernel walks, per block, one 128-row
lane group of each slot of its slab block on the score tile of
``csrc/score_tile.cuh`` (``chunk_schedule`` is its index math), on the back
end ``backend`` picks.

Each (query, row) pair packs the true squared distance's f32 bits, with the
low ``code_bits`` replaced by the row's provenance, into one int32 key; the
table [expand * tile/128, B, 128] keeps the minimum key per (slab, lane)
bin. See ``csrc/binscan.cu`` for the bin geometry and why an atomic minimum
gives the TPU's first-touch table.
"""

from __future__ import annotations

import torch

from . import _build, score_tile
from .scan_topk import _refine, check_cuda_operands

#: Packed-key provenance budget: more code bits eat too many of the value's
#: mantissa bits for reliable selection. Every eligibility gate derives from
#: it, as in the JAX package.
PROVENANCE_BITS_MAX = 13
INT32_MAX = 2**31 - 1
LANES = 128
#: Waves of blocks a K7/K8 launch aims for, at the blocks an SM holds.
_TARGET_WAVES = 2
#: Rows per step of the plain scans: bounds their [B, rows] score block.
_PLAIN_ROWS = 65536


def provenance_split(n_tiles: int, tile: int) -> tuple[int, int]:
    """(tg_bits, g3_bits) a packed key spends addressing ``n_tiles`` tiles
    of ``tile`` rows: tile-group bits + lane-group (slab) bits."""
    n_lg = tile // LANES
    tg_bits = max(1, ((n_tiles - 1) // n_lg).bit_length())
    g3_bits = max(1, (n_lg - 1).bit_length())
    return tg_bits, g3_bits


def provenance_bits(n_tiles: int, tile: int) -> int:
    """Total provenance bits for ``n_tiles`` tiles of ``tile`` rows."""
    return sum(provenance_split(n_tiles, tile))


def binscan_b_tile(
    tile: int, d: int, esize: int, expand: int = 1, budget: int = 12 * 2**20
) -> int:
    """Largest query block whose working set fits the JAX kernel's VMEM
    model, or 0. Kept as the rule that picks the bin geometry (tile and
    expand, hence the bins and so the recall), so that one searcher has the
    same bins in both packages; the card kernel's own limits are checked
    where it launches. ``esize == 1`` is the int8-code variant."""
    emb_block = 2 * tile * d * esize
    row_extra = 2 * tile * 4 if esize == 1 else 0
    for bt in (512, 256, 128, 64, 32, 16, 8):
        acc = 2 * expand * (tile // LANES) * bt * LANES * 4
        q_block = bt * d * esize + bt * LANES * 4
        if esize == 1:
            q_block += 2 * bt * LANES * 4
        if emb_block + row_extra + acc + q_block <= budget:
            return bt
    return 0


def quantize_queries_i8(q: torch.Tensor):
    """Symmetric per-query int8 quantization: (codes int8 [B, d], scale f32
    [B]) with q ~= scale[b] * codes[b]; zero queries get scale 1. Bit for
    bit the JAX package's as compiled: XLA turns the division by 127 into a
    multiplication by its f32 reciprocal; codes round half to even."""
    qa = q.abs().amax(dim=1)
    tq = torch.where(qa > 0, qa * (1.0 / 127.0), 1.0)
    qi = torch.round(q / tq[:, None]).clamp(-127, 127).to(torch.int8)
    return qi, tq


def _geometry(n_units: int, n_pad: int, tile: int, expand: int, what: str):
    """Check a scan's bin geometry -> (tg_bits, code_bits)."""
    if tile <= 0 or n_pad % tile or tile % LANES:
        raise ValueError(f"n_pad={n_pad} must be a multiple of tile={tile}")
    n_lg = tile // LANES
    if expand < 1 or (expand > 1 and n_units < expand * n_lg):
        raise ValueError(
            f"expand={expand} needs {what} >= expand*n_lg "
            f"({n_units} < {expand * n_lg})"
        )
    tg_bits, g3_bits = provenance_split(n_units, tile)
    code_bits = tg_bits + g3_bits
    if code_bits > PROVENANCE_BITS_MAX:
        raise ValueError(
            f"binscan key precision too low for {what}={n_units} at "
            f"tile={tile} ({code_bits} provenance bits); raise tile or scan fewer tiles"
        )
    return tg_bits, code_bits


def _prepare_queries(q, emb, scale):
    """(qs, qsq, qt): -2q in the storage dtype (qt None), or the int8 query
    codes with qt = -2 * their scale; |q|^2 in f32."""
    qf = q.float()
    qsq = (qf * qf).sum(dim=1)
    if scale is not None:
        qs, tq = quantize_queries_i8(qf)
        return qs, qsq, -2.0 * tq
    return (-2.0 * qf).to(emb.dtype), qsq, None


def _check_operands(q, emb, emb_sq, scale, sel):
    if q.dim() != 2 or emb.dim() != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, emb {tuple(emb.shape)}")
    if emb_sq.dtype != torch.float32 or emb_sq.shape != (emb.shape[0],):
        raise TypeError("emb_sq must be float32 [n_pad]")
    if scale is None:
        if emb.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError("emb is float32 or bfloat16 (int8 codes need a scale)")
    elif emb.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.shape != (emb.shape[0],):
        raise TypeError("int8 codes take a float32 [n_pad] row scale")
    if sel is not None and (sel.dtype != torch.int32 or sel.dim() != 1):
        raise TypeError("sel must be int32 [cap]")
    tensors = [t for t in (q, emb, emb_sq, scale, sel) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all operands must be on one device")


def _keys_plain(qs, qsq, qt, emb, emb_sq, scale, tiles, tile, expand, tg_bits,
                code_bits):
    """The key table in plain torch. ``tiles`` [n_units] holds the tile of
    each slot; slot t folds into slab (t + g3) % n_lg + (tg % expand) * n_lg
    with tg = t // n_lg, as ``_binscan_body`` does."""
    dev = emb.device
    b, d = qs.shape
    n_lg = tile // LANES
    n_units = tiles.shape[0]
    hi_mask = ~((1 << code_bits) - 1)
    # [B, slabs, 128] while folding, so a scatter along dim 1 picks slabs
    table = torch.full((b, expand * n_lg, LANES), INT32_MAX, dtype=torch.int32,
                       device=dev)
    g3 = torch.arange(n_lg, device=dev)
    offs = torch.arange(tile, device=dev)
    # int8 dots are exact in f32 while every partial sum stays below 2^24
    dot_dtype = torch.float32 if d * 127 * 127 < 2**24 else torch.float64
    group = max(1, _PLAIN_ROWS // tile)
    for s0 in range(0, n_units, group):
        slots = torch.arange(s0, min(s0 + group, n_units), device=dev)
        g = slots.shape[0]
        rows = (tiles[slots].long()[:, None] * tile + offs[None, :]).reshape(-1)
        x, sq = emb[rows], emb_sq[rows]
        if scale is None:
            part = (qs.float() @ x.float().T + sq[None, :]) + qsq[:, None]
        else:
            dots = (qs.to(dot_dtype) @ x.to(dot_dtype).T).float()
            part = (dots * (qt[:, None] * scale[rows][None, :]) + sq[None, :]) \
                + qsq[:, None]
            part = torch.where(part < 0, 0.0, part)
        bits = part.contiguous().view(torch.int32).view(b, g, n_lg, LANES)
        tg = slots // n_lg
        code = (g3[None, :] << tg_bits) + tg[:, None]  # [g, n_lg]
        keys = (bits & hi_mask) | code[None, :, :, None].to(torch.int32)
        slab = (slots[:, None] + g3[None, :]) % n_lg + (tg % expand)[:, None] * n_lg
        idx = slab.reshape(1, g * n_lg, 1).expand(b, g * n_lg, LANES)
        table.scatter_reduce_(1, idx, keys.reshape(b, g * n_lg, LANES), "amin")
    return table.permute(1, 0, 2).contiguous()


def backend(emb, qs) -> str:
    """The score tile's back end of a K7/K8 launch: ``"dp4a"`` for int8
    codes, else ``score_tile.pick_backend`` (``"wgmma"`` for bf16 with
    ``d % 8 == 0`` and 16-byte aligned arrays, ``"fma"`` otherwise)."""
    if emb.dtype == torch.int8:
        return "dp4a"
    return score_tile.pick_backend(emb.dtype, emb.shape[1], qs.data_ptr(), emb.data_ptr())


def splits_for(batch: int, backend_: str, n_units: int, tile: int, expand: int) -> int:
    """Splits of each slab block's slots: about ``_TARGET_WAVES`` waves of
    (query group, slab, split) blocks, at one block an SM for 128 queries a
    block and two for 64, never more splits than a slab block has slots."""
    queries = score_tile.block_queries(batch, backend_)
    pairs = -(-batch // queries) * expand * (tile // LANES)
    per_sm = 1 if queries == 128 else 2
    per_block = -(-n_units // expand)  # slots of one slab block, at most
    return max(1, min(per_block, _TARGET_WAVES * score_tile.SM_COUNT * per_sm // pairs))


def chunk_schedule(n_units: int, n_lg: int, expand: int, splits: int):
    """The lane groups each block of a query group scores, in the kernel's
    index math (``SlabChunks`` in ``csrc/binscan.cu``) -> {(slab, split):
    [(slot, g3), ...]}: the slots of slab block e = slab // n_lg (tile groups
    e, e + expand, ...) cut into ``splits`` runs, and of each slot the lane
    group g3 that folds into slab ``slab``."""
    out = {}
    full, rem = divmod(n_units, n_lg)
    for slab in range(expand * n_lg):
        e, sl = divmod(slab, n_lg)
        m_full = -(-(full - e) // expand) if full > e else 0
        cnt = m_full * n_lg + (rem if rem and full % expand == e else 0)
        for split in range(splits):
            lo, hi = cnt * split // splits, cnt * (split + 1) // splits
            chunks = []
            for i in range(lo, hi):
                slot = (e + (i // n_lg) * expand) * n_lg + i % n_lg
                chunks.append((slot, (sl - slot % n_lg) % n_lg))
            out[(slab, split)] = chunks
    return out


def _keys_cuda(name, qs, qsq, qt, emb, emb_sq, scale, sel, n_units, tile,
               expand, tg_bits, code_bits):
    n_lg = tile // LANES
    check_cuda_operands(
        **{k: v for k, v in dict(q=qs, qsq=qsq, qt=qt, emb=emb, emb_sq=emb_sq,
                                 scale=scale, sel=sel).items() if v is not None}
    )
    lib = _build.load()
    b, d = qs.shape
    back = backend(emb, qs)
    splits = splits_for(b, back, n_units, tile, expand)
    out = torch.full((expand * n_lg, b, LANES), INT32_MAX, dtype=torch.int32,
                     device=emb.device)
    dtype = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}[emb.dtype]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    head = [ptr(qs), ptr(qsq), ptr(qt), ptr(emb), ptr(emb_sq), ptr(scale)]
    if sel is not None:
        head.append(ptr(sel))
    rc = getattr(lib, name)(
        *head, b, d, tile, n_units, expand, tg_bits, code_bits, splits, dtype,
        int(back == "wgmma"), out.data_ptr(), _build.stream_ptr(),
    )
    _build.check(rc, name)
    _build.LAUNCHES["K8" if sel is not None else "K7"] += 1
    return out


def _keys(q, emb, emb_sq, sel, tile, expand, scale, plain):
    _check_operands(q, emb, emb_sq, scale, sel)
    n_pad = emb.shape[0]
    n_units = n_pad // tile if sel is None else sel.shape[0]
    tg_bits, code_bits = _geometry(
        n_units, n_pad, tile, expand, "nt" if sel is None else "cap"
    )
    qs, qsq, qt = _prepare_queries(q, emb, scale)
    if plain or emb.device.type == "cpu":
        tiles = torch.arange(n_units, device=emb.device) if sel is None else sel
        return _keys_plain(qs, qsq, qt, emb, emb_sq, scale, tiles, tile, expand,
                           tg_bits, code_bits)
    name = "pqv_binned_scan" if sel is None else "pqv_binned_scan_select"
    return _keys_cuda(name, qs.contiguous(), qsq, qt, emb, emb_sq, scale, sel,
                      n_units, tile, expand, tg_bits, code_bits)


def binned_scan_keys(q, emb, emb_sq, tile: int, expand: int = 1, scale=None):
    """K7's key table [expand * tile/128, B, 128] int32 for f32 queries
    ``q`` [B, d] over ``emb`` [n_pad, d] (f32, bf16, or int8 codes with a
    row ``scale``) and ``emb_sq`` [n_pad] f32 (+3e38 on pad rows)."""
    return _keys(q, emb, emb_sq, None, tile, expand, scale, plain=False)


def binned_scan_keys_plain(q, emb, emb_sq, tile: int, expand: int = 1, scale=None):
    """``binned_scan_keys`` in plain torch, on any device."""
    return _keys(q, emb, emb_sq, None, tile, expand, scale, plain=True)


def binned_scan_select_keys(q, emb, emb_sq, sel, tile: int, expand: int = 1,
                            scale=None):
    """K8's key table: K7 over the tiles ``sel`` [cap] int32, slot t
    scanning tile sel[t]; provenance is slot-relative."""
    return _keys(q, emb, emb_sq, sel, tile, expand, scale, plain=False)


def binned_scan_select_keys_plain(q, emb, emb_sq, sel, tile: int, expand: int = 1,
                                  scale=None):
    """``binned_scan_select_keys`` in plain torch, on any device."""
    return _keys(q, emb, emb_sq, sel, tile, expand, scale, plain=True)


def _merge_bins(q, emb, keys, k, tile, n_units, sel, kf_mult=2, kf_floor=0):
    """Cross-bin top-kf, provenance decode, exact re-score -> (d² [B, k],
    ids [B, k]). The JAX package's ``lax.top_k(~keys)`` is index-stable, so
    equal keys go to the lower bin; a stable sort does the same. The slab
    block (slab // n_lg) is redundant with tg % expand and is dropped."""
    n_lg = tile // LANES
    tg_bits, g3_bits = provenance_split(n_units, tile)
    code_bits = tg_bits + g3_bits
    n_slabs, b, _ = keys.shape
    kf = min(max(kf_mult * k, kf_floor), n_slabs * LANES)
    flat = keys.permute(1, 0, 2).reshape(b, n_slabs * LANES)
    key, bins = torch.sort(flat, dim=1, stable=True)
    key, bins = key[:, :kf], bins[:, :kf]
    code = key & ((1 << code_bits) - 1)
    tg = code & ((1 << tg_bits) - 1)
    g3 = code >> tg_bits
    slab = (bins // LANES) % n_lg
    lane = bins % LANES
    t_row = tg * n_lg + (slab - g3) % n_lg
    if sel is not None:
        t_row = sel.long()[t_row.clamp(0, sel.shape[0] - 1)]
    row = (t_row * tile + g3 * LANES + lane).to(torch.int32)
    val = (key & ~((1 << code_bits) - 1)).view(torch.float32)
    d2, ids = _refine(q, emb, val, row, out_k=k)
    return d2[:, :k], ids[:, :k]


def _scan(q, emb, emb_sq, sel, k, tile, expand, scale, emb_ref):
    if k > expand * tile:
        raise ValueError(f"binscan requires k <= {expand * tile} bins (got k={k})")
    keys = _keys(q, emb, emb_sq, sel, tile, expand, scale, plain=False)
    n_units = emb.shape[0] // tile if sel is None else sel.shape[0]
    return _merge_bins(
        q.float(), emb if emb_ref is None else emb_ref, keys, k, tile, n_units,
        sel, kf_mult=2 if scale is None else 4, kf_floor=0 if scale is None else 32,
    )


def binned_scan(q, emb, emb_sq, k: int, tile: int = 1024, expand: int = 1,
                scale=None, emb_ref=None):
    """Brute-force top-k through the fused binned-min scan
    (``pallas_binned_scan``) -> (squared distances [B, k], ids [B, k]).

    Winners are re-scored in f32 against ``emb_ref`` (or ``emb``); selection
    misses only on cross-tile bin collisions. Int8 codes (``scale`` given)
    re-score against ``emb_ref`` and fetch max(4k, 32) bins, f32/bf16 2k."""
    return _scan(q, emb, emb_sq, None, k, tile, expand, scale, emb_ref)


def binned_scan_select(q, emb, emb_sq, sel, k: int, tile: int = 2048,
                       expand: int = 1, scale=None, emb_ref=None):
    """The binned-min scan over the tiles ``sel`` [cap] int32
    (``pallas_binned_scan_select``) -> (squared distances [B, k], global
    ids [B, k])."""
    return _scan(q, emb, emb_sq, sel, k, tile, expand, scale, emb_ref)
