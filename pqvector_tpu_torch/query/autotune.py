"""Serving-plan autotuner: pick (mode, nprobe) for a recall target.

Counterpart of ``pqvector_tpu/query/autotune.py``. The searcher exposes
many modes whose recall/throughput trade differs by batch size and array
shape; a deployment should not hand-pick. It calibrates once against a
representative query sample and serves the measured winner.

Method:
  1. Ground truth = the searcher's own exact top-k (on a spilled layout
     still the true top-k: the dedup preserves exactness).
  2. For each eligible mode: probed modes walk the nprobe grid upward
     until measured recall@k clears the target (recall is monotone in
     nprobe); full-scan modes (nprobe-free) get one recall measurement.
  3. Qualifying modes are timed with ``search_loop``; each run ends with
     the ids copied to the host and, on the card, a device synchronisation,
     so the timer measures the work and not its enqueueing.
  4. Plans are ranked by QPS; ``autotune`` returns them all, best first.

The timer is injectable so the ranking logic is unit-testable without a
device clock. ``probe_weather`` compares the ``mm`` + row-min floor with
``mm`` + the scan's extraction on the searcher's resident array, the report
``DeviceIvfSearcher.scan_route`` (``mode="autoscan"``) routes by. The JAX
package's int8 validation gate is not ported: it guards Mosaic kernels on
a TPU, and ``chip_smoke.py`` holds the int8 kernels to their plain versions
on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..errors import ValidationError

#: Modes the tuner considers, and whether nprobe shapes their recall.
#: "gather" is deliberately absent: it targets B = 1..16 latency and has no
#: loop path (``search_loop`` raises on it), so a loop-throughput ranking
#: would mis-time it; measure it with single calls instead.
PROBED_MODES = ("masked", "pallas", "stream", "compact", "bincompact",
                "bincompact8")
SCAN_MODES = ("scan", "binscan", "xbin", "xbin8", "binscan8", "tilescan")
#: Left out of the default candidates, as in the JAX package (they measured
#: 1.0-1.4% of the TPU's bf16 peak there); ``modes=(...)`` still serves them.
DEPRIORITIZED = ("xbin", "xbin8", "tilescan")


def _default_candidates():
    """Every probed and every scan mode but ``DEPRIORITIZED``, the int8
    modes included: the JAX package's list for any backend other than the
    TPU."""
    return tuple(m for m in PROBED_MODES + SCAN_MODES if m not in DEPRIORITIZED)


@dataclass(frozen=True)
class WeatherReport:
    """Result of :func:`probe_weather`. ``extract_frac`` is the extraction
    loop's throughput as a fraction of the floor loop's, on the same array
    in the same window; ``degraded`` compares it with the caller's
    threshold."""

    floor_qps: float  #: mm + row-min loop QPS (the floor)
    extract_qps: float  #: mm + the scan's top-k extraction loop QPS
    extract_frac: float  #: extract_qps / floor_qps
    degraded: bool  #: extract_frac < degraded_below
    batch: int
    k: int


def probe_weather(
    searcher,
    queries,
    k: int = 10,
    *,
    reps: int = 25,
    budget_s: float = 2.0,
    degraded_below: float = 0.25,
    timer=time.perf_counter,
) -> WeatherReport:
    """Time the ``mm`` + row-min floor against ``mm`` + the scan's top-k
    extraction (``_approx_min_k_clamped``, what ``mode="scan"`` runs) on the
    searcher's resident array, its rows in chunks of ``_approx_chunk`` with
    the finite pad norms, and classify the window.

    Each loop runs ``reps`` repetitions, each one's queries depending on
    every query's output of the one before; a warm-up of the same ``reps``
    goes first, then loops until ``budget_s`` has passed or 16 x ``reps``
    repetitions have run, each ended by a device synchronisation. On the
    JAX package's TPU, extraction dropped to ~1/6 of the floor in degraded
    windows; the card's report is its own, and ``degraded`` follows
    ``degraded_below`` as written."""
    from .device import _approx_min_k_clamped, _chunk_scores

    q = queries.detach().cpu().numpy() if isinstance(queries, torch.Tensor) else queries
    q = np.asarray(q, np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if q.ndim != 2 or not len(q):
        raise ValidationError("probe_weather needs a [B, d] query sample")
    if k < 1:
        raise ValidationError("k must be >= 1")
    emb_dim = int(searcher.emb.shape[1])
    if q.shape[1] != emb_dim:
        raise ValidationError(f"query dim {q.shape[1]} != index dim {emb_dim}")

    emb = searcher.emb
    sq = searcher._pallas_emb_sq()  # finite pad: +inf would poison the sum
    q0 = torch.from_numpy(q).to(emb.device)
    n_pad = int(emb.shape[0])
    chunk = searcher._approx_chunk(len(q))
    rt = searcher.approx_recall_target

    def loop(extract: bool):
        carry = torch.zeros((), device=emb.device)
        for _ in range(reps):
            qf = (q0 + carry).to(emb.dtype)
            out = None
            for lo in range(0, n_pad, chunk):
                scores = _chunk_scores(qf, emb[lo : lo + chunk], sq[lo : lo + chunk],
                                       torch.float32)
                best = (_approx_min_k_clamped(scores, k, rt)[0][:, 0] if extract
                        else scores.amin(dim=1))
                out = best if out is None else torch.minimum(out, best)
            carry = 0.0 * out.sum()  # every query's output feeds the next
        if emb.is_cuda:
            torch.cuda.synchronize(emb.device)

    def timed(extract: bool) -> float:
        loop(extract)  # warm-up with the timed calls' reps
        n = 0
        t0 = timer()
        while True:
            loop(extract)
            n += reps
            if timer() - t0 >= budget_s or n >= 16 * reps:
                break
        return n * len(q) / max(timer() - t0, 1e-9)

    floor = timed(False)
    extract = timed(True)
    frac = extract / max(floor, 1e-9)
    return WeatherReport(
        floor_qps=floor,
        extract_qps=extract,
        extract_frac=frac,
        degraded=frac < degraded_below,
        batch=len(q),
        k=k,
    )


@dataclass(frozen=True)
class ServingPlan:
    """One calibrated serving configuration."""

    mode: str
    nprobe: int  # 0 for the nprobe-free scan modes
    recall: float
    qps: float
    batch: int
    k: int
    notes: str = ""


@dataclass
class AutotuneReport:
    """Ranked plans (best QPS first) + per-mode diagnostics."""

    plans: list[ServingPlan] = field(default_factory=list)
    rejected: dict[str, str] = field(default_factory=dict)

    @property
    def best(self) -> ServingPlan | None:
        return self.plans[0] if self.plans else None


def _host(ids) -> np.ndarray:
    return ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)


def _recall_at_k(ids, truth: np.ndarray) -> float:
    hits = sum(
        len(set(a.tolist()) & set(b.tolist()))
        for a, b in zip(_host(ids), truth)
    )
    return hits / truth.size


def autotune(
    searcher,
    queries: np.ndarray,
    k: int = 10,
    recall_target: float = 0.95,
    nprobe_grid: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64),
    modes: tuple[str, ...] | None = None,
    reps: int = 4,
    budget_s: float = 2.0,
    timer=time.perf_counter,
) -> AutotuneReport:
    """Calibrate serving plans for ``searcher`` on ``queries``.

    ``modes=None`` considers every eligible mode. ``reps``/``budget_s``
    bound the timing loop per mode (reps per ``search_loop`` call;
    wall-clock budget per mode). Raises ValidationError on an empty or
    ragged sample.
    """
    q = np.asarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None, :]
    if q.ndim != 2 or not len(q):
        raise ValidationError("autotune needs a [B, d] query sample")

    truth_ids = _host(searcher.exact(q, k)[1])
    report = AutotuneReport()

    candidates = modes if modes is not None else _default_candidates()
    for mode in candidates:
        try:
            plan = _tune_mode(
                searcher, mode, q, k, truth_ids, recall_target,
                nprobe_grid, reps, budget_s, timer,
            )
        except ValidationError as e:  # ineligible shape/k for this mode
            report.rejected[mode] = str(e)
            continue
        if plan is None:
            report.rejected[mode] = (
                f"recall target {recall_target} not reached"
            )
        else:
            report.plans.append(plan)
    report.plans.sort(key=lambda p: p.qps, reverse=True)
    return report


def _tune_mode(
    searcher, mode, q, k, truth_ids, recall_target, nprobe_grid,
    reps, budget_s, timer,
) -> ServingPlan | None:
    kc = searcher.index.n_clusters
    batch = len(q)
    if mode in SCAN_MODES:
        grid = (kc,)  # nprobe is ignored by the scan modes
    else:
        grid = tuple(p for p in sorted(set(nprobe_grid)) if p <= kc)
        if not grid or grid[-1] < kc:
            grid = grid + (kc,)  # always give full coverage a chance

    chosen = None
    recall = 0.0
    for nprobe in grid:
        if mode in ("bincompact", "bincompact8") and hasattr(
            searcher, "calibrate_bincompact"
        ):
            ct, _ = searcher.calibrate_bincompact(
                q, nprobe, k, esize=1 if mode == "bincompact8" else None
            )
            if not ct:
                raise ValidationError(f"{mode} ineligible for this shape")
        _, ids = searcher.search(q, k, max(nprobe, 1), mode=mode)
        recall = _recall_at_k(ids, truth_ids)
        if recall >= recall_target:
            chosen = nprobe
            break
    if chosen is None:
        return None

    # Throughput: budget-bounded repeats of the loop.
    def run():
        _, ids = searcher.search_loop(
            q, k, max(chosen, 1), reps=reps, mode=mode
        )
        ids.cpu()  # materialize: the result reached the host
        if ids.is_cuda:
            torch.cuda.synchronize(ids.device)

    run()  # warm-up (kernel builds, lazy tables) outside the timed window
    n = 0
    t0 = timer()
    while True:
        run()
        n += reps
        if timer() - t0 >= budget_s or n >= 8 * reps:
            break
    elapsed = max(timer() - t0, 1e-9)
    qps = n * batch / elapsed
    return ServingPlan(
        mode=mode,
        nprobe=0 if mode in SCAN_MODES else chosen,
        recall=recall,
        qps=qps,
        batch=batch,
        k=k,
        notes="nprobe-free full scan" if mode in SCAN_MODES else "",
    )
