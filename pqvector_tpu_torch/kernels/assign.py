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
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from . import _build

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
#: Dimensions of one stage of the screen: the tensor cores sum the products
#: of one stage (3 pieces x 64 dimensions) from zero.
_SCREEN_STAGE_DIMS = 64
#: Rows the screen has scored on the card, rows it left uncertified, and
#: calls whose probe sent every row to the FMA form, since the last
#: ``reset_screen_counts``.
SCREENED = {"rows": 0, "uncertified": 0, "fma_after_probe": 0}


def reset_screen_counts() -> None:
    for key in SCREENED:
        SCREENED[key] = 0


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


def _gamma(m: float, u: float) -> float:
    return m * u / (1.0 - m * u)


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


def bf16_route(d: int, k: int, *addresses: int) -> str:
    """Which kernel assigns bf16 rows on the card: ``"screen"`` where
    ``d % 8 == 0`` and every array is 16-byte aligned (the 16-byte copies
    into the swizzled stages) and ``d >= SCREEN_MIN_DIM``; ``"fma"``
    otherwise. ``k`` does not enter the rule: the screen takes any k."""
    if d % 8 == 0 and d >= SCREEN_MIN_DIM and all(a % 16 == 0 for a in addresses):
        return "screen"
    return "fma"


def rescore_all(uncertified: int, probed: int, d: int) -> bool:
    """After the screen's probe: whether the FMA form should assign every
    row, where the probe left more of its rows uncertified than
    ``RESCORE_BREAK_EVEN`` allows at ``d`` (linear between its points, the
    end points' shares beyond them). The ids are K1 f32's either way; only
    the time differs."""
    dims, shares = zip(*RESCORE_BREAK_EVEN)
    return uncertified > float(np.interp(d, dims, shares)) * probed


def _certified(x: torch.Tensor, values: torch.Tensor, alpha_w: float, alpha: float,
               beta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(best id, certified) of rows ``x`` whose approximate values are
    ``values`` [rows, k] f32, by the kernel's rule."""
    if values.shape[1] > 1:
        two = torch.topk(values, 2, dim=1, largest=False).values.double()
        gap = two[:, 1] - two[:, 0]
    else:
        gap = torch.where(torch.isnan(values[:, 0]), math.nan, math.inf).double()
    x64 = x.double()
    w = torch.arange(x.shape[1], 0, -1, dtype=torch.float64, device=x.device)
    xn = torch.sqrt((x64 ** 2).sum(dim=1)) * (1.0 + 2.0**-30)
    xw = torch.sqrt(((w * x64) ** 2).sum(dim=1)) * (1.0 + 2.0**-30)
    e = (alpha_w * xw + alpha * xn + beta) * (1.0 + 2.0**-20)
    return torch.argmin(values, dim=1).to(torch.int32), gap > 2.0 * e


def screen_values_plain(x: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """The screen's [n, k] f32 values in plain torch: a stage's three pieces
    summed in f32 matmuls (lo, mid, hi, as the kernel orders them), the
    stages added in f32, then ``|c|^2 - 2 s``."""
    c_norm = (centroids * centroids).sum(dim=1)
    pf = split_bf16x3(centroids).float()
    xf = x.float()
    acc = None
    for d0 in range(0, x.shape[1], _SCREEN_STAGE_DIMS):
        xs = xf[:, d0 : d0 + _SCREEN_STAGE_DIMS]
        part = sum(xs @ pf[p, :, d0 : d0 + _SCREEN_STAGE_DIMS].T for p in (2, 1, 0))
        acc = part if acc is None else acc + part
    return c_norm[None, :] - 2.0 * acc


def screen_value_bound(x: torch.Tensor, pieces: torch.Tensor, c_norm: torch.Tensor,
                       ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The tensor-core model of ``csrc/assign.cu``'s header, row by row, for
    each row of ``x`` and its centroid ``ids``: ([n] float64 ``|c|^2 - 2 x.(hi
    + mid + lo)``, [n] float64 bound on how far the screen's value may lie
    from it). Each k16 step counts as 17 roundings of at most u' = 2^-23 of
    what they round, the stages are added in fp32, the value takes one fmaf,
    and underflow adds ``eta``; the float64 sums here add their own bound."""
    n, d = x.shape
    u, u2 = 2.0**-24, 2.0**-23
    prod = x.double()[None] * pieces[:, ids.long()].double()   # [3, n, d], exact
    t = prod.sum(dim=(0, 2))
    s_hi, s_mid, s_lo = prod.abs().sum(dim=2)
    n_st = -(-d // _SCREEN_STAGE_DIMS)
    g_n = _gamma(n_st, u)
    steps = 17 * (_SCREEN_STAGE_DIMS // 16)
    e = ((_gamma(steps, u2) * s_hi + _gamma(2 * steps, u2) * s_mid
          + _gamma(3 * steps, u2) * s_lo) * (1.0 + g_n)
         + g_n * (1.0 + _gamma(3 * steps, u2)) * (s_hi + s_mid + s_lo))
    own = _gamma(3 * d, 2.0**-53) * (s_hi + s_mid + s_lo)  # the float64 sum of t
    cn = c_norm.double()[ids.long()]
    eta = 4.0 * (d + 1 + 386 * n_st) * 2.0**-126
    bound = 2.0 * (e + own) + u * (cn.abs() + 2.0 * (t.abs() + e + own)) + eta
    return cn - 2.0 * t, bound * (1.0 + 2.0**-20)


def assign_rows_screened_plain(x: torch.Tensor, centroids: torch.Tensor
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The screen and its re-score in plain torch: ([n] int32 ids, [n] bool
    certified). ``screen_values_plain`` a block of rows at a time, then the
    certificate of ``screen_coefficients``; rows it does not certify take
    ``assign_rows_plain``'s id."""
    c_norm = (centroids * centroids).sum(dim=1)
    coef = screen_coefficients(centroids, c_norm, split_bf16x3(centroids))
    n = x.shape[0]
    ids = torch.empty(n, dtype=torch.int32, device=x.device)
    cert = torch.empty(n, dtype=torch.bool, device=x.device)
    for lo in range(0, n, _PLAIN_BLOCK):
        xb = x[lo : lo + _PLAIN_BLOCK]
        got = _certified(xb.float(), screen_values_plain(xb, centroids), *coef)
        ids[lo : lo + _PLAIN_BLOCK], cert[lo : lo + _PLAIN_BLOCK] = got
    rest = torch.nonzero(~cert).flatten()
    if rest.numel():
        ids[rest] = assign_rows_plain(x[rest], centroids)
    return ids, cert


def _launch_fma(lib, x, centroids, c_norm, out, key) -> None:
    """One launch of K1's bf16-row FMA form, counted under ``key`` too."""
    n, d = x.shape
    rc = lib.pqv_assign_bf16(x.data_ptr(), centroids.data_ptr(), c_norm.data_ptr(), n, d,
                             centroids.shape[0], out.data_ptr(), _build.stream_ptr())
    _build.check(rc, "pqv_assign_bf16")
    for name in ("K1", "K1_bf16") + ((key,) if key else ()):
        _build.LAUNCHES[name] += 1


def _screen_inputs(centroids: torch.Tensor, c_norm: torch.Tensor
                   ) -> tuple[torch.Tensor, tuple[float, float, float]]:
    """The screen's per-launch inputs: the split centroids [3, k, d] bf16 and
    the certificate's coefficients."""
    pieces = split_bf16x3(centroids).contiguous()
    return pieces, screen_coefficients(centroids, c_norm, pieces)


def _launch_screen(lib, x, pieces, c_norm, coef, out, flags, value) -> None:
    """One launch of K1's screen over the rows ``x`` into ``out``, ``flags``
    (and ``value`` unless None)."""
    n, d = x.shape
    rc = lib.pqv_assign_bf16_screen(x.data_ptr(), pieces.data_ptr(), c_norm.data_ptr(), n, d,
                                    pieces.shape[1], *coef, out.data_ptr(), flags.data_ptr(),
                                    0 if value is None else value.data_ptr(),
                                    _build.stream_ptr())
    _build.check(rc, "pqv_assign_bf16_screen")
    for name in ("K1", "K1_bf16", "K1_bf16_screen"):
        _build.LAUNCHES[name] += 1


def screen(x: torch.Tensor, centroids: torch.Tensor, c_norm: torch.Tensor,
           values: bool = False) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """One launch of K1's screen on the card: ([n] int32 ids, [n] uint8
    certified flags, and with ``values`` the screen's [n] f32 value of each
    id). A certified row's id is the f32 form's over the widened row; the
    others' ids are the screen's guess. Raises where the screen cannot run."""
    n, d = x.shape
    k = centroids.shape[0]
    if (x.dtype != torch.bfloat16 or centroids.dtype != torch.float32
            or c_norm.dtype != torch.float32
            or centroids.shape[1] != d or c_norm.shape != (k,)
            or not (x.is_contiguous() and centroids.is_contiguous() and c_norm.is_contiguous())
            or not x.device == centroids.device == c_norm.device
            or x.device.type != "cuda"):
        raise ValueError("screen takes contiguous bf16 rows, f32 centroids and their f32 "
                         "norms on one CUDA device")
    lib = _build.load()
    pieces, coef = _screen_inputs(centroids, c_norm)
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    flags = torch.empty(n, dtype=torch.uint8, device=x.device)
    value = torch.empty(n, dtype=torch.float32, device=x.device) if values else None
    _launch_screen(lib, x, pieces, c_norm, coef, out, flags, value)
    return out, flags, value


def _assign_bf16_cuda(x: torch.Tensor, centroids: torch.Tensor, c_norm: torch.Tensor,
                      route: str | None, probe: int) -> torch.Tensor:
    """K1 on bf16 rows by ``route`` (default ``bf16_route``). The screen
    route: the first ``probe`` rows screened (all of them where ``n <= 2
    probe`` or ``probe`` is 0); where ``rescore_all`` says so the FMA form
    over every row, else the screen over the rest and the FMA form over the
    rows left uncertified, gathered and scattered back."""
    route = route or bf16_route(x.shape[1], centroids.shape[0], x.data_ptr())
    n = x.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    lib = _build.load()
    if route == "fma":
        _launch_fma(lib, x, centroids, c_norm, out, None)
        return out
    if route != "screen":
        raise ValueError(f"unknown route {route!r}")
    flags = torch.empty(n, dtype=torch.uint8, device=x.device)
    pieces, coef = _screen_inputs(centroids, c_norm)
    p = probe if 0 < probe and 2 * probe < n else n
    _launch_screen(lib, x[:p], pieces, c_norm, coef, out[:p], flags[:p], None)
    if p < n:
        probed = int((flags[:p] == 0).sum())
        if rescore_all(probed, p, x.shape[1]):
            SCREENED["rows"] += p
            SCREENED["uncertified"] += probed
            SCREENED["fma_after_probe"] += 1
            _launch_fma(lib, x, centroids, c_norm, out, None)
            return out
        _launch_screen(lib, x[p:], pieces, c_norm, coef, out[p:], flags[p:], None)
    rest = torch.nonzero(flags == 0).flatten()
    SCREENED["rows"] += n
    SCREENED["uncertified"] += rest.numel()
    if rest.numel():
        again = torch.empty(rest.numel(), dtype=torch.int32, device=x.device)
        _launch_fma(lib, x.index_select(0, rest), centroids, c_norm, again,
                    "K1_bf16_rescore")
        out.index_copy_(0, rest, again)
    return out


def _assign_cuda(x: torch.Tensor, centroids: torch.Tensor, route: str | None = None,
                 probe: int = PROBE_ROWS) -> torch.Tensor:
    """K1 on the card; for bf16 rows ``route`` ("screen" or "fma") overrides
    ``bf16_route`` and ``probe`` the rows the screen probes (0: none)."""
    c_norm = (centroids * centroids).sum(dim=1).contiguous()
    if x.dtype == torch.bfloat16:
        return _assign_bf16_cuda(x, centroids, c_norm, route, probe)
    lib = _build.load()
    n, d = x.shape
    out = torch.empty(n, dtype=torch.int32, device=x.device)
    rc = lib.pqv_assign(x.data_ptr(), centroids.data_ptr(), c_norm.data_ptr(), n, d,
                        centroids.shape[0], out.data_ptr(), _build.stream_ptr())
    _build.check(rc, "pqv_assign")
    _build.LAUNCHES["K1"] += 1
    return out


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
