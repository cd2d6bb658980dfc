"""K1: nearest-centroid assignment, ``argmin_c |c|^2 - 2 x.c`` per row.

Counterpart of ``pqvector_tpu/kernels/assign.py`` (``pallas_assign``). On
CUDA tensors ``assign_rows`` launches the hand-written kernels
(``csrc/assign.cu``, on the score tile of ``csrc/score_tile.cuh``: a block
owns 128 rows of ``x`` and walks the centroids in IEEE fp32 FMA, keeping a
running argmin in registers); on CPU tensors it runs ``assign_rows_plain``,
the same function in plain torch. Ties keep the lowest centroid index, as
``jnp.argmin`` does.

``x`` may be bf16, the resident matrix of a build under the bf16 wire. On
the card the ids are then those of the f32 form over ``x.float()``, bit for
bit, without a full-size f32 copy, by one of two routes (``bf16_route``):
the FMA form, the f32 form's arithmetic on rows widened as they are staged;
or, for wide rows, the screen: the centroids split into three bf16 pieces
(``split_bf16x3``), every row scored on the tensor cores, and a row's id
kept where the gap between its two best approximate values exceeds twice
a proven bound on how far those values and the f32 form's can lie apart
(``screen_coefficients``; the proof is in ``csrc/assign.cu``). The rows
that are not certified, ties among them, are gathered and scored again by
the FMA form. On a large call the screen takes the first ``PROBE_ROWS``
rows first; where it leaves more of them uncertified than
``RESCORE_BREAK_EVEN`` allows at that d (data full of ties), the FMA form
assigns every row instead (``rescore_all``). ``assign_rows_screened_plain``
is the route in plain torch. The plain version widens one block of rows at
a time. The centroids are always f32.

Large calls of f32 rows take the same kind of route (``f32_route``; a small
one, such as Lloyd's on its training sample, goes to ``pqv_assign`` whole:
the route's fixed host cost would exceed what it saves). The screen over
f32 rows splits each row, as its stages land, into bf16 pieces xh and xm
(``split_f32_rows``) and sums three piece products on the tensor cores
(``F32_SCREEN_PAIRS``); its certificate (``screen_coefficients_f32``) also
bounds the products it leaves out, so a certified row's id is
``pqv_assign``'s. The rows it leaves uncertified are
gathered, a bounded block at a time, and scored again by ``pqv_assign``,
which stays the FMA form of f32 rows; ``RESCORE_BREAK_EVEN_F32`` is its
probe's rule. No id of either route ever comes from TF32 or from the screen
alone: a row is either certified or re-scored in IEEE fp32.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .._device import resolve_device
from . import _build, score_tile

#: Rows per block of the plain version: bounds its [block, k] score matrix.
_PLAIN_BLOCK = 8192
#: The screen's route (``bf16_route``): rows of at least this many
#: dimensions, a multiple of 8 (``scripts/torch_score_tile_check.py
#: --sweep`` on the H100: the screen wins at d = 64 and above, loses at 32).
SCREEN_MIN_DIM = 64
#: A call of more than twice this many rows screens these first: the share
#: of them left uncertified decides how the rest are assigned.
PROBE_ROWS = 65536
#: (d, share): above the share, interpolated in d, of uncertified probe rows
#: the FMA form over every row is faster than the screen and its re-score
#: (where the two cross in ``scripts/torch_score_tile_check.py
#: --share-sweep`` on the H100, 1M x d x 1000; the lower of two runs).
RESCORE_BREAK_EVEN = ((64, 0.08), (96, 0.25), (128, 0.32), (512, 0.66), (1024, 0.71))
#: The f32-row screen's route (``f32_route``): rows of at least this many
#: dimensions, a multiple of 8 (``scripts/torch_score_tile_check.py --sweep``
#: on the H100: the route beats ``pqv_assign`` from d = 128 in every run,
#: loses at 32 and 64, and at 96 wins or loses by the run).
F32_SCREEN_MIN_DIM = 128
#: ... and calls of at least this much work, n x k x d: the route costs
#: 0.8-1.1 ms more than its kernels (the certificate's coefficients, two
#: host syncs, the re-score's gather and at least one wave of ``pqv_assign``),
#: which a smaller call does not earn back (``scripts/torch_k1_lloyd_check.py``
#: on the H100: the route and ``pqv_assign`` cross near 350,000 x 128 x 1024
#: and 61,000 x 1024 x 1000, 4.5e10 and 6.2e10; Lloyd's 50,000-row sample
#: lost 2.3-2.9x at d = 128 and 1.05-1.08x at 1024).
F32_SCREEN_MIN_WORK = 6.4e10
#: The pairs (row piece, centroid piece) the f32-row screen sums, in the
#: order the tensor cores add them, small products first: xm.hi, xh.mid,
#: xh.hi, with 0 for xh / hi and 1 for xm / mid. The kernel's own are in
#: ``csrc/score_tile.cuh`` (``kScreenPairs``, ``screen_pair_row``,
#: ``screen_pair_centroid``); every f32-row screen launch first holds this
#: copy, which the certificate is computed from, to them (``kernel_pairs``).
#: Each row piece meets a prefix of the centroid pieces; what the pairs leave
#: out, the certificate bounds. Six pairs (a third piece of both) were
#: slower at every d from 32 to 1024 (``scripts/torch_score_tile_check.py
#: --sweep`` on the H100).
F32_SCREEN_PAIRS = ((1, 0), (0, 1), (0, 0))
#: ``RESCORE_BREAK_EVEN`` for f32 rows: where the f32-row screen and its
#: re-score cross ``pqv_assign`` over every row (``--share-sweep`` on the
#: H100, 1M x d x 1000; the lower of two runs).
RESCORE_BREAK_EVEN_F32 = ((128, 0.23), (512, 0.48), (1024, 0.52))
#: Bytes of rows one re-score gathers at most, so that the gather of the
#: uncertified rows of a large call does not raise a build's peak memory.
RESCORE_BLOCK_BYTES = 1 << 28
#: Dimensions of one stage of the screen: the tensor cores sum the products
#: of one stage (3 pieces x 64 dimensions) from zero.
_SCREEN_STAGE_DIMS = 64
#: Rows the screen has scored on the card, rows it left uncertified, and
#: calls whose probe sent every row to the FMA form, since the last
#: ``reset_screen_counts``: bf16 rows under the bare names, f32 rows under
#: ``f32_``.
SCREENED = {"rows": 0, "uncertified": 0, "fma_after_probe": 0,
            "f32_rows": 0, "f32_uncertified": 0, "f32_fma_after_probe": 0}


def reset_screen_counts() -> None:
    for key in SCREENED:
        SCREENED[key] = 0


def screen_counts() -> dict[str, int]:
    """Rows screened and rows left uncertified, bf16 and f32 rows together:
    the counters of the build's ``build.assign`` stage."""
    return {"k1.rows": SCREENED["rows"] + SCREENED["f32_rows"],
            "k1.uncertified": SCREENED["uncertified"] + SCREENED["f32_uncertified"]}


def assign_rows_plain(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[n, d] f32 or bf16 x [k, d] f32 -> [n] int32, in plain torch."""
    c_norm = (centroids * centroids).sum(dim=1)
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    for lo in range(0, x.shape[0], _PLAIN_BLOCK):
        scores = x[lo : lo + _PLAIN_BLOCK].float() @ centroids.T
        out[lo : lo + _PLAIN_BLOCK] = torch.argmin(
            c_norm[None, :] - 2.0 * scores, dim=1
        ).to(torch.int32)
    return out


def split_bf16x3(centroids: torch.Tensor) -> torch.Tensor:
    """[k, d] f32 -> [3, k, d] bf16: hi = bf16(c), mid = bf16(c - hi),
    lo = bf16(c - hi - mid), each cast rounding to nearest. Each difference
    is exact in f32, so ``hi + mid + lo == c`` bit for bit wherever
    |c| >= 2^-110; below that ``lo`` falls under bf16's least subnormal
    (2^-133) and the sum misses c by less than 2^-133
    (``screen_coefficients`` counts that residual)."""
    hi = centroids.to(torch.bfloat16)
    r1 = centroids - hi.float()
    mid = r1.to(torch.bfloat16)
    lo = (r1 - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def split_f32_rows(x: torch.Tensor) -> torch.Tensor:
    """[n, d] f32 -> [3, n, d] f32: the f32-row screen's pieces of each value
    v, as its stages split them (``csrc/score_tile.cuh``: ``split_step``):
    xh = RN_bf16(v), xm = RN_bf16(v - xh), each 0 where it would be under
    2^-126 (no subnormal piece reaches the tensor cores), and what they leave,
    xr = v - xh - xm. Every difference is exact in f32, so ``xh + xm + xr ==
    v`` bit for bit; xh and xm are bf16 values."""
    out = []
    rest = x.float()
    for _ in range(2):
        piece = rest.to(torch.bfloat16).float()
        piece = torch.where(piece.abs() < 2.0**-126, torch.zeros_like(piece), piece)
        out.append(piece)
        rest = rest - piece
    return torch.stack(out + [rest])


def _gamma(m: float, u: float) -> float:
    return m * u / (1.0 - m * u)


def _pairs(x: torch.Tensor) -> tuple[list[torch.Tensor], tuple[tuple[int, int], ...]]:
    """The row pieces [n, d] f32 the screen multiplies, and its pairs (row
    piece, centroid piece) in the order the tensor cores add them: bf16 rows
    are one exact piece against lo, mid, hi; f32 rows ``split_f32_rows``
    against ``F32_SCREEN_PAIRS``."""
    if x.dtype == torch.bfloat16:
        return [x.float()], ((0, 2), (0, 1), (0, 0))
    return list(split_f32_rows(x)[:2]), F32_SCREEN_PAIRS


def screen_coefficients(centroids: torch.Tensor, c_norm: torch.Tensor,
                        pieces: torch.Tensor) -> tuple[float, float, float]:
    """(alpha_w, alpha, beta) of the screen's certificate: for a row x with
    ``X >= |x|_2`` and ``X_w >= |((d - i) x_i)_i|_2``, ``alpha_w X_w + alpha X
    + beta`` bounds how far the screen's value of any centroid lies from the
    f32 form's (``csrc/assign.cu``'s header derives it). Not finite when a
    centroid is not: then no row is certified."""
    d = centroids.shape[1]
    u, u2 = 2.0**-24, 2.0**-23
    c64, p64 = centroids.double(), pieces.double()
    norms = torch.stack([
        c64.norm(dim=1).max(),                         # C
        p64.abs().sum(0).norm(dim=1).max(),            # P
        (c64 - p64.sum(0)).norm(dim=1).max(),          # R
        c_norm.double().abs().max(),                   # CN
        *p64.norm(dim=2).max(dim=1).values,            # H, M, L: each piece
    ]).cpu().tolist()
    up = 1.0 + 2.0**-30  # the f64 reductions' own rounding
    cap, pcap, rcap, cn, hcap, mcap, lcap = (v * up for v in norms)
    g_f = u / (1.0 - d * u)
    n_st = -(-d // _SCREEN_STAGE_DIMS)
    g_n = _gamma(n_st, u)
    steps = 17 * (_SCREEN_STAGE_DIMS // 16)  # roundings a piece's products pass through
    e_s = ((_gamma(steps, u2) * hcap + _gamma(2 * steps, u2) * mcap
            + _gamma(3 * steps, u2) * lcap) * (1.0 + g_n)
           + g_n * (1.0 + _gamma(3 * steps, u2)) * pcap)
    alpha_w = 2.0 * g_f * cap * (1.0 + u)
    alpha = 4.0 * u * cap + 2.0 * (1.0 + u) * (e_s + rcap)
    beta = 2.0 * u * cn + 4.0 * (d + 1 + 386 * n_st) * 2.0**-126
    return alpha_w, alpha, beta


def screen_coefficients_f32(centroids: torch.Tensor, c_norm: torch.Tensor,
                            pieces: torch.Tensor) -> tuple[float, ...]:
    """(alpha_w, alpha, a_h, a_m, a_r, beta, x_limit) of the f32-row screen's
    certificate: for a row x with ``X >= |x|_2``, ``X_w >= |((d - i)
    x_i)_i|_2`` and ``X_h``, ``X_m``, ``X_r`` >= the norms of its pieces
    (``split_f32_rows``), ``alpha_w X_w + alpha X + a_h X_h + a_m X_m + a_r X_r
    + beta`` bounds how far the screen's value of any centroid lies from
    ``pqv_assign``'s, wherever ``X <= x_limit`` (then no sum of either form can
    overflow). ``csrc/assign.cu``'s header derives it. Not finite when a
    centroid is not: then no row is certified."""
    d = centroids.shape[1]
    u, u2 = 2.0**-24, 2.0**-23
    c64, p64 = centroids.double(), pieces.double()
    kept = torch.cumsum(p64, 0)  # hi, hi + mid, hi + mid + lo
    norms = torch.stack([
        c64.norm(dim=1).max(),                                      # C = D_0
        *(c64 - kept[:2]).norm(dim=2).max(dim=1).values,            # D_1, D_2
        *torch.cumsum(p64.abs(), 0)[:2].norm(dim=2).max(dim=1).values,  # P_1, P_2
        *p64.norm(dim=2).max(dim=1).values[:2],                     # H, M
        c_norm.double().abs().max(),                                # CN
    ]).cpu().tolist()
    up = 1.0 + 2.0**-30  # the f64 reductions' own rounding
    cap, d1, d2, p1, p2, hcap, mcap, cn = (v * up for v in norms)
    rest, sums, piece = (cap, d1, d2), (0.0, p1, p2), (hcap, mcap)
    g_f = u / (1.0 - d * u)
    n_st = -(-d // _SCREEN_STAGE_DIMS)
    g_n = _gamma(n_st, u)
    steps = 17 * (_SCREEN_STAGE_DIMS // 16)  # roundings of one pair's products in a stage
    pairs = F32_SCREEN_PAIRS
    deepest = _gamma(steps * len(pairs), u2)
    a_row = []
    for p in range(2):
        q_p = sum(1 for a, _ in pairs if a == p)  # centroid pieces 0 .. q_p - 1 meet piece p
        hw = sum(_gamma(steps * (len(pairs) - j), u2) * piece[q]
                 for j, (a, q) in enumerate(pairs) if a == p)
        a_row.append(2.0 * (1.0 + u) * ((1.0 + g_n) * hw + g_n * (1.0 + deepest) * sums[q_p]
                                        + rest[q_p]))
    a_row.append(2.0 * (1.0 + u) * cap)  # the residual xr meets nothing
    alpha_w = 2.0 * g_f * cap * (1.0 + u)
    alpha = 4.0 * u * cap
    beta = 2.0 * u * cn + 4.0 * (d + 1 + (128 * len(pairs) + 2) * n_st) * 2.0**-126
    x_limit = (2.0**127 - cn) / (2.5 * cap) if cap > 0 else math.inf
    return (alpha_w, alpha, *a_row, beta, x_limit)


def _route(d: int, min_dim: int, addresses) -> str:
    if d % 8 == 0 and d >= min_dim and all(a % 16 == 0 for a in addresses):
        return "screen"
    return "fma"


def bf16_route(d: int, k: int, *addresses: int) -> str:
    """Which kernel assigns bf16 rows on the card: ``"screen"`` where
    ``d % 8 == 0`` and every array is 16-byte aligned (the 16-byte copies
    into the swizzled stages) and ``d >= SCREEN_MIN_DIM``; ``"fma"``
    otherwise. ``k`` does not enter the rule: the screen takes any k."""
    return _route(d, SCREEN_MIN_DIM, addresses)


def f32_route(n: int, d: int, k: int, *addresses: int) -> str:
    """Which kernel assigns ``n`` f32 rows on the card: ``"screen"`` (the
    f32-row screen, then ``pqv_assign`` over the rows it leaves uncertified)
    where ``d % 8 == 0``, every array is 16-byte aligned, ``d >=
    F32_SCREEN_MIN_DIM`` and ``n k d >= F32_SCREEN_MIN_WORK``; ``"fma"``
    (``pqv_assign`` over every row) otherwise."""
    if n * k * d < F32_SCREEN_MIN_WORK:
        return "fma"
    return _route(d, F32_SCREEN_MIN_DIM, addresses)


def rescore_all(uncertified: int, probed: int, d: int,
                table: tuple[tuple[int, float], ...] = RESCORE_BREAK_EVEN) -> bool:
    """After the screen's probe: whether the FMA form should assign every
    row, where the probe left more of its rows uncertified than ``table``
    (``RESCORE_BREAK_EVEN`` for bf16 rows, ``RESCORE_BREAK_EVEN_F32`` for
    f32 rows) allows at ``d`` (linear between its points, the end points'
    shares beyond them). The ids are K1 f32's either way; only the time
    differs."""
    dims, shares = zip(*table)
    return uncertified > float(np.interp(d, dims, shares)) * probed


def _row_norms(x: torch.Tensor) -> torch.Tensor:
    """[n, 2 or 5] float64 of rows ``x``, as the kernels sum them: X, X_w and,
    for f32 rows, the norms of the three pieces of ``split_f32_rows``; each
    rounded up by 2^-30."""
    x64 = x.double()
    w = torch.arange(x.shape[1], 0, -1, dtype=torch.float64, device=x.device)
    cols = [(x64 ** 2).sum(dim=1), ((w * x64) ** 2).sum(dim=1)]
    if x.dtype == torch.float32:
        cols += list((split_f32_rows(x).double() ** 2).sum(dim=2))
    return torch.sqrt(torch.stack(cols, dim=1)) * (1.0 + 2.0**-30)


def _certified(x: torch.Tensor, values: torch.Tensor, coef: tuple[float, ...]
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(best id, certified) of rows ``x`` whose approximate values are
    ``values`` [rows, k] f32, by the kernel's rule: ``coef`` is
    ``screen_coefficients``' (bf16 rows) or ``screen_coefficients_f32``'s
    (f32 rows)."""
    if values.shape[1] > 1:
        two = torch.topk(values, 2, dim=1, largest=False).values.double()
        gap = two[:, 1] - two[:, 0]
    else:
        gap = torch.where(torch.isnan(values[:, 0]), math.nan, math.inf).double()
    norms = _row_norms(x)
    if x.dtype == torch.bfloat16:
        alpha_w, alpha, beta = coef
        e, ok = alpha_w * norms[:, 1] + alpha * norms[:, 0] + beta, True
    else:
        alpha_w, alpha, *a_row, beta, x_limit = coef
        e = alpha_w * norms[:, 1] + alpha * norms[:, 0] + beta
        for j, a in enumerate(a_row):
            e = e + a * norms[:, 2 + j]
        ok = norms[:, 0] <= x_limit
    e = e * (1.0 + 2.0**-20)
    return torch.argmin(values, dim=1).to(torch.int32), (gap > 2.0 * e) & ok


def screen_values_plain(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """The screen's [n, k] f32 values in plain torch: a stage's pairs of
    pieces (``_pairs``: bf16 rows against lo, mid, hi; f32 rows their pieces
    against ``F32_SCREEN_PAIRS``) summed in f32 matmuls in the kernel's
    order, the stages added in f32, then ``|c|^2 - 2 s``."""
    c_norm = (centroids * centroids).sum(dim=1)
    pf = split_bf16x3(centroids).float()
    xp, pairs = _pairs(x)
    acc = None
    for d0 in range(0, x.shape[1], _SCREEN_STAGE_DIMS):
        st = slice(d0, d0 + _SCREEN_STAGE_DIMS)
        part = sum(xp[a][:, st] @ pf[q, :, st].T for a, q in pairs)
        acc = part if acc is None else acc + part
    return c_norm[None, :] - 2.0 * acc


def screen_value_bound(x: torch.Tensor, pieces: torch.Tensor, c_norm: torch.Tensor,
                       ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core model of ``csrc/assign.cu``'s header, row by row, for
    each row of ``x`` (bf16 or f32) and its centroid ``ids``: ([n] float64
    ``|c|^2 - 2 t'``, t' the exact sum of the pairs the screen multiplies
    (``_pairs``; bf16 rows: ``x.(hi + mid + lo)``), [n] float64 bound on how
    far the screen's value may lie from it). Each k16 step counts as 17
    roundings of at most u' = 2^-23 of what they round, the stages are added
    in fp32, the value takes one fmaf, and underflow adds ``eta``; the
    float64 sums here add their own bound."""
    n, d = x.shape
    u, u2 = 2.0**-24, 2.0**-23
    xp, pairs = _pairs(x)
    cp = pieces[:, ids.long()].double()
    prods = [xp[a].double() * cp[q] for a, q in pairs]   # each [n, d], exact
    t = sum(p.sum(dim=1) for p in prods)
    sums = [p.abs().sum(dim=1) for p in prods]
    total = sum(sums)
    n_st = -(-d // _SCREEN_STAGE_DIMS)
    g_n = _gamma(n_st, u)
    steps = 17 * (_SCREEN_STAGE_DIMS // 16)
    deepest = _gamma(steps * len(pairs), u2)
    e = (sum(_gamma(steps * (len(pairs) - j), u2) * s for j, s in enumerate(sums))
         * (1.0 + g_n) + g_n * (1.0 + deepest) * total)
    own = _gamma(len(pairs) * d, 2.0**-53) * total  # the float64 sum of t
    cn = c_norm.double()[ids.long()]
    eta = 4.0 * (d + 1 + (128 * len(pairs) + 2) * n_st) * 2.0**-126
    bound = 2.0 * (e + own) + u * (cn.abs() + 2.0 * (t.abs() + e + own)) + eta
    return cn - 2.0 * t, bound * (1.0 + 2.0**-20)


def _coefficients(x: torch.Tensor, centroids: torch.Tensor, c_norm: torch.Tensor,
                  pieces: torch.Tensor) -> tuple[float, ...]:
    """The certificate's coefficients for rows of ``x``'s dtype and width."""
    if x.dtype == torch.bfloat16:
        return screen_coefficients(centroids, c_norm, pieces)
    return screen_coefficients_f32(centroids, c_norm, pieces)


def assign_rows_screened_plain(x: torch.Tensor, centroids: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The screen and its re-score in plain torch, for bf16 or f32 rows: ([n]
    int32 ids, [n] bool certified). ``screen_values_plain`` a block of rows
    at a time, then the certificate of ``screen_coefficients`` (bf16 rows) or
    ``screen_coefficients_f32`` (f32 rows); rows it does not certify take
    ``assign_rows_plain``'s id."""
    c_norm = (centroids * centroids).sum(dim=1)
    coef = _coefficients(x, centroids, c_norm, split_bf16x3(centroids))
    n = x.shape[0]
    ids = torch.empty(n, dtype=torch.int32, device=x.device)
    cert = torch.empty(n, dtype=torch.bool, device=x.device)
    for lo in range(0, n, _PLAIN_BLOCK):
        xb = x[lo : lo + _PLAIN_BLOCK]
        got = _certified(xb, screen_values_plain(xb, centroids), coef)
        ids[lo : lo + _PLAIN_BLOCK], cert[lo : lo + _PLAIN_BLOCK] = got
    rest = torch.nonzero(~cert).flatten()
    if rest.numel():
        ids[rest] = assign_rows_plain(x[rest], centroids)
    return ids, cert


def _count(*names: str) -> None:
    for name in names:
        _build.LAUNCHES[name] += 1


def _launch_fma(lib, x, centroids, c_norm, out, key) -> None:
    """One launch of K1's FMA form for ``x``'s dtype (``pqv_assign`` on f32
    rows, ``pqv_assign_bf16`` on bf16 rows), counted under ``key`` too."""
    n, d = x.shape
    fn = "pqv_assign_bf16" if x.dtype == torch.bfloat16 else "pqv_assign"
    rc = getattr(lib, fn)(x.data_ptr(), centroids.data_ptr(), c_norm.data_ptr(), n, d,
                          centroids.shape[0], out.data_ptr(), _build.stream_ptr())
    _build.check(rc, fn)
    _count("K1", *(("K1_bf16",) if x.dtype == torch.bfloat16 else ()), *((key,) if key else ()))


def _screen_inputs(x: torch.Tensor, centroids: torch.Tensor, c_norm: torch.Tensor
                   ) -> tuple[torch.Tensor, tuple[float, ...]]:
    """The screen's per-launch inputs for rows like ``x``: the split
    centroids [3, k, d] bf16 and the certificate's coefficients."""
    pieces = split_bf16x3(centroids).contiguous()
    return pieces, _coefficients(x, centroids, c_norm, pieces)


@functools.lru_cache(maxsize=None)
def kernel_pairs(lib) -> tuple[tuple[int, int], ...]:
    """The pairs (row piece, centroid piece) the built f32-row screen sums,
    in its order (``pqv_assign_f32_screen_pairs``)."""
    row, centroid = (ctypes.c_int * 8)(), (ctypes.c_int * 8)()
    m = lib.pqv_assign_f32_screen_pairs(row, centroid)
    return tuple((row[j], centroid[j]) for j in range(m))


def _launch_screen(lib, x, pieces, c_norm, coef, out, flags, value) -> None:
    """One launch of K1's screen over the rows ``x`` (bf16 or f32) into
    ``out``, ``flags`` (and ``value`` unless None)."""
    n, d = x.shape
    tail = (out.data_ptr(), flags.data_ptr(), 0 if value is None else value.data_ptr(),
            _build.stream_ptr())
    if x.dtype == torch.bfloat16:
        rc = lib.pqv_assign_bf16_screen(x.data_ptr(), pieces.data_ptr(), c_norm.data_ptr(), n,
                                        d, pieces.shape[1], *coef, *tail)
        _build.check(rc, "pqv_assign_bf16_screen")
        _count("K1", "K1_bf16", "K1_bf16_screen")
        return
    if kernel_pairs(lib) != F32_SCREEN_PAIRS:
        raise RuntimeError(f"the f32-row screen sums the pairs {kernel_pairs(lib)}, its "
                           f"certificate is for {F32_SCREEN_PAIRS}")
    rc = lib.pqv_assign_f32_screen(x.data_ptr(), pieces.data_ptr(), c_norm.data_ptr(), n, d,
                                   pieces.shape[1], (ctypes.c_double * 7)(*coef), *tail)
    _build.check(rc, "pqv_assign_f32_screen")
    _count("K1", "K1_f32_screen")


def screen(x: torch.Tensor, centroids: torch.Tensor, c_norm: torch.Tensor,
           values: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """One launch of K1's screen on the card, over bf16 or f32 rows: ([n]
    int32 ids, [n] uint8 certified flags, and with ``values`` the screen's
    [n] f32 value of each id). A certified row's id is the f32 form's (over
    the widened row, for bf16 rows); the others' ids are the screen's guess.
    Raises where the screen cannot run."""
    n, d = x.shape
    k = centroids.shape[0]
    if (x.dtype not in (torch.bfloat16, torch.float32) or centroids.dtype != torch.float32
            or c_norm.dtype != torch.float32
            or centroids.shape[1] != d or c_norm.shape != (k,)
            or not (x.is_contiguous() and centroids.is_contiguous() and c_norm.is_contiguous())
            or not x.device == centroids.device == c_norm.device
            or x.device.type != "cuda"):
        raise ValueError("screen takes contiguous bf16 or f32 rows, f32 centroids and their "
                         "f32 norms on one CUDA device")
    lib = _build.load()
    pieces, coef = _screen_inputs(x, centroids, c_norm)
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    flags = torch.empty(n, dtype=torch.uint8, device=x.device)
    value = torch.empty(n, dtype=torch.float32, device=x.device) if values else None
    _launch_screen(lib, x, pieces, c_norm, coef, out, flags, value)
    return out, flags, value


def _rescore(lib, x, centroids, c_norm, out, rest, key) -> None:
    """The FMA form over the rows ``rest`` of ``x``, gathered at most
    ``RESCORE_BLOCK_BYTES`` at a time (whole waves of the FMA form's two
    blocks an SM), their ids scattered into ``out``."""
    wave = 2 * score_tile.SM_COUNT * score_tile.CHUNK_ROWS
    per = max(wave, RESCORE_BLOCK_BYTES // (x.shape[1] * x.element_size()) // wave * wave)
    for lo in range(0, rest.numel(), per):
        idx = rest[lo : lo + per]
        again = torch.empty(idx.numel(), dtype=torch.int32, device=x.device)
        _launch_fma(lib, x.index_select(0, idx), centroids, c_norm, again, key)
        out.index_copy_(0, idx, again)


def _assign_routed(x: torch.Tensor, centroids: torch.Tensor, c_norm: torch.Tensor,
                   route: str | None, probe: int) -> torch.Tensor:
    """K1 on bf16 or f32 rows by ``route`` (default ``bf16_route`` or
    ``f32_route``). The screen route: the first ``probe`` rows screened (all
    of them where ``n <= 2 probe`` or ``probe`` is 0); where ``rescore_all``
    says so the FMA form over every row, else the screen over the rest and
    the FMA form over the rows left uncertified (``_rescore``)."""
    bf16 = x.dtype == torch.bfloat16
    n, d = x.shape
    k = centroids.shape[0]
    route = route or (bf16_route(d, k, x.data_ptr()) if bf16
                      else f32_route(n, d, k, x.data_ptr()))
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    lib = _build.load()
    if route == "fma":
        _launch_fma(lib, x, centroids, c_norm, out, None)
        return out
    if route != "screen":
        raise ValueError(f"unknown route {route!r}")
    tag = "" if bf16 else "f32_"
    flags = torch.empty(n, dtype=torch.uint8, device=x.device)
    pieces, coef = _screen_inputs(x, centroids, c_norm)
    p = probe if 0 < probe and 2 * probe < n else n
    _launch_screen(lib, x[:p], pieces, c_norm, coef, out[:p], flags[:p], None)
    if p < n:
        probed = int((flags[:p] == 0).sum())
        if rescore_all(probed, p, d, RESCORE_BREAK_EVEN if bf16 else RESCORE_BREAK_EVEN_F32):
            SCREENED[tag + "rows"] += p
            SCREENED[tag + "uncertified"] += probed
            SCREENED[tag + "fma_after_probe"] += 1
            _launch_fma(lib, x, centroids, c_norm, out, None)
            return out
        _launch_screen(lib, x[p:], pieces, c_norm, coef, out[p:], flags[p:], None)
    rest = torch.nonzero(flags == 0).flatten()
    SCREENED[tag + "rows"] += n
    SCREENED[tag + "uncertified"] += rest.numel()
    if rest.numel():
        _rescore(lib, x, centroids, c_norm, out, rest,
                 "K1_bf16_rescore" if bf16 else "K1_f32_rescore")
    return out


def _assign_cuda(x: torch.Tensor, centroids: torch.Tensor, route: str | None = None,
                 probe: int = PROBE_ROWS) -> torch.Tensor:
    """K1 on the card; ``route`` ("screen" or "fma") overrides ``bf16_route``
    or ``f32_route`` and ``probe`` the rows the screen probes (0: none)."""
    c_norm = (centroids * centroids).sum(dim=1).contiguous()
    return _assign_routed(x, centroids, c_norm, route, probe)


def assign_rows(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids for every row of ``x`` ([n, d] -> [n] int32).

    ``x`` is float32 or bfloat16, the centroids float32, both on one
    device. The kernel masks the ragged last block itself, so rows need no
    padding."""
    if x.dtype not in (torch.float32, torch.bfloat16) or centroids.dtype != torch.float32:
        raise TypeError("assign_rows takes float32 or bfloat16 rows and float32 centroids")
    if x.dim() != 2 or centroids.dim() != 2 or x.shape[1] != centroids.shape[1]:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, centroids {tuple(centroids.shape)}"
        )
    if x.device != centroids.device:
        raise ValueError("x and centroids must be on one device")
    if x.device.type == "cpu":
        return assign_rows_plain(x, centroids)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _assign_cuda(x.contiguous(), centroids.contiguous())


def assign_clusters(
    x: np.ndarray | torch.Tensor,
    centroids: np.ndarray | torch.Tensor,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Host-friendly form: any row count in, numpy ids out (the counterpart
    of ``assign_clusters_pallas``). A bf16 tensor stays bf16."""
    device = resolve_device(device)
    bf16 = isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
    xt = torch.as_tensor(x, dtype=torch.bfloat16 if bf16 else torch.float32, device=device)
    ct = torch.as_tensor(centroids, dtype=torch.float32, device=device)
    return assign_rows(xt, ct).cpu().numpy()
