"""End-to-end smoke of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a Hopper GPU, the CUDA
toolkit (nvcc) and pyarrow. It imports nothing of JAX or of the JAX
package. Phases, in order; any failure exits non-zero and prints no result:

1. Environment: the card, torch, nvcc; TF32 off; build the kernels
   (``csrc/*.cu``, compiled at first use) and time the build.
2. Each kernel (K1 assign, K2 stream exact, K3 stream masked, K4 masked
   local, K5 exact per-tile, K6 masked per-tile, K7 binned scan, K8 binned
   scan over selected tiles, K9 tile min, K10 tile gather, K11 tile gather
   by bulk copies) against its plain torch version on the card: small
   awkward shapes (ties, pad rows, fewer rows than k, k = 1 and 128, k near
   the bin count, f32, bf16 and int8, expand 1/2/4, fewer selected slots
   than tiles, tiles of 2 to 2048 rows, all-pad tiles, repeated and
   unordered selections; for K9 and K5 also what their 128 x 128 score tile
   makes awkward: B = 129 and 257, d = 8, 96, 100, 136 on both back ends,
   k = 128 at 128 queries; for K1 and K2, which run on the same tile, d = 3
   and 100, 1 to 4096 centroids, B = 1 to 4096 and four splits of the rows;
   for K4 and K3 on that tile also a last tile whose last chunks are all pad
   rows, a tile of 64 chunks, unsorted slots, 1 to 300 clusters a tile, three
   splits of the active tiles, and their counters of scored tiles and chunks
   equal to the skip rule's; for K6 on that tile the same in file order, its
   counters held to ``masked_scan_chunks``; for K7 and K8 on that tile every
   back end, wgmma, the fp32 patch and the dp4a patch, at 64 and 128
   queries a block) must agree exactly; at the main path's shapes the
   ids must agree except where the two picks tie within the f32 tolerance
   (the int8 key tables exactly, K9 within the certificate's envelope, the
   gathers bit for bit), and both are timed with CUDA events (median of
   10), beside one PyTorch call or two-call chain that computes the same
   function where there is one, and the bound: the least time the card
   could take for the call's bytes and operations. K9, K5, K4, K3 and K2
   are timed on the f32 and on the bf16 array, K2 also at k = 100; K10 and
   K11 also in turns with ``index_select``, 10 rounds.
3. The main path at the bench's default configuration: a seeded 1M x 128
   Parquet file, ``IndexBuilder(...).n_clusters(1024).build_inplace()`` on
   the card, exact truth from K2 on an f32 searcher, and an nprobe sweep of
   IVF ``search`` (K4) on a bf16 searcher with an f32 re-score copy until
   recall@10 >= 0.95; K3 must return K4's ids; exact k = 100 through K2
   must match the plain scan; search QPS at B = 256 through K4 and K3.
4. Coverage: K1-K4 were launched during phase 3.
5. Slice 2's path on the same file and index: a bf16 searcher in file
   order (f32 re-score copy) serves ``search(..., "pallas")`` through K6 in
   an nprobe sweep to recall@10 >= 0.95, ``exact(..., "pallas")`` through
   K5 (rows that differ from K2's pick tie at the storage precision),
   ``binscan`` through K7 (recall >= 0.95) and
   ``binscan8``; the cluster-sorted bf16 searcher calibrates and serves
   ``bincompact`` through K8 (recall >= 0.95) and ``bincompact8``. QPS at
   B = 256, coverage, and K6 against ``gather`` at B = 1 .. 256 for the
   ``auto`` route. K5-K8 must all have been launched.
6. The DEEP-shaped rung: 10M x 96 rows (1024 modes, seed 77) generated in
   memory, IVF-4096 built on the card (K1), f32 truth from K2 for the first
   256 queries of the seed-7 draw, then ``bincompact`` (calibrated, sorted
   bf16 layout) and ``binscan`` (file-order bf16 layout) at B = 256:
   recall, QPS and coverage; K6 against ``gather`` at B = 1, 16 and 256 for
   the ``auto`` route.
7. Slice 3's path on the 1M file (f32 truth searcher and sorted bf16
   searcher with its f32 copy): ``exact(mode="cert")`` through K9 for pass 1
   ``highest`` and ``storage`` must equal the K2 truth (ids tied at equal
   distance may swap), certified or through the K2 fallback, which one run
   with ``cert_fetch_tiles = 1`` forces; ``search`` modes ``compact`` (K10),
   ``scan``, ``approx`` and ``masked``: recall against the limits, ms per
   batch and QPS through ``search_loop``/``exact_loop``; a torch.profiler
   breakdown of ``cert`` and ``compact``. 7b, inside phase 6 on the 10M
   rung's sorted searcher: ``compact`` at nprobe 4 (cap, coverage, recall,
   ms), K10 and K11 on that selection (bit-equal to the plain gather and to
   each other, timed beside ``index_select``), ``cert`` equal to the K2
   truth, and K9, K5, K4, K3, K2 and K1 timed at that rung's shapes (K9
   within the certificate's envelope of its plain version, K5's merge equal
   to K2's, K4's merge and K3 equal to each other and to K3's plain version
   up to near-ties, K1 against 4096 centroids equal to its plain version up
   to near-ties).
8. The front doors on the same rows, rewritten with an offset index and
   8-row pages so the page-exact reader serves candidate reads, and
   indexed in place (K1; index bytes equal phase 3's): 64 of the queries,
   each as ``SELECT id FROM t ORDER BY array_distance(embedding, [...])
   LIMIT 10`` and again with ``WHERE id >= 500000``, through a host-path
   ``Session`` (nprobe 8), a resident one with an f32 ``device_searcher`` and
   one with a bf16 searcher and its f32 copy; and ``TopkBuilder`` for the
   first 8 of the plain form. The native page decoder must have built. The resident sessions must take the resident path on every
   query (``resident_candidates`` > 0, 0 on the host session) and give the
   host path's ids, as must ``TopkBuilder`` (rows tied at the k-th distance
   may swap); ``explain()`` shows ``VectorTopKExec``; one query at nprobe 32
   re-scores its candidates on the card (``_device_sqdist``) with the ids of
   the host re-score; ``python -m pqvector_tpu_torch info`` and ``search
   --device-mode auto`` run as subprocesses, the latter with the ids of
   ``DeviceIvfSearcher.from_parquet(...).search(q, 10, 8, "auto")``. Recall
   against the K2 truth, the median ms per query of each door and the
   resident path's share in its device search go into a ``front doors:``
   line.

9. Slice 9's path on the phase-3 file and index, launch counts from 0:
   (a) ``with_spill(spill=0.2)`` as bf16 storage with its f32 copy (200k
   extra rows): ``search(auto)`` (K4 at k = 20) swept over nprobe until
   recall@10 >= 0.95, each nprobe beside the unspilled searcher's recall
   (never more than 0.002 under it); no row repeats an id; ``stream`` (K3)
   gives K4's ids; an f32 spilled searcher's ``exact(stream)`` (K2 at 2k)
   is the K2 truth; ``from_parquet(path, spill=0.2)`` gives ``with_spill``'s
   ids; ``bincompact`` (K8) calibrated to recall >= 0.95; ms a batch
   spilled and unspilled. (c) ``autotune`` on the sorted bf16 searcher
   (k = 10, target 0.95): every plan meets the target, ``pallas`` and
   ``stream`` among them, ``gather`` in none. (b) 10,000 deletes (the K2
   top-1 of the first 64 queries among them) and 4,096 appends (the queries
   + 1e-3, then rows drawn as the file's): ``search`` auto, stream, binscan,
   bincompact and ``exact`` stream, pallas, cert return no deleted id and no
   empty slot, each query's appended copy first; the same updates on the f32
   truth searcher, whose ``exact(stream)`` equals a plain f32 scan over the
   live and appended rows (the bf16 searcher's, a 2k shortlist selected at
   storage precision, has against it at least its recall of the K2 truth
   before the updates, less 0.005); ``search(auto)`` ms with and without
   the state, and a torch.profiler breakdown of both. (d) On copies of the file: the staged
   ``build_inplace`` (index bytes equal phase 3's; its stages beside phase
   3's and the column's pyarrow and native read times), ``build_new``
   (same bytes; pyarrow reads it), ``cluster_sorted().build_new`` (same
   centroids and list sizes, rows in ``index.row_ids`` order, served by
   ``from_parquet`` at phase 3's recall at nprobe 8) and
   ``streaming(131072).build_inplace`` (one seed, identical bytes; K1 once
   per batch; recall at nprobe 8 within 0.01 of phase 3's).

10. Slice 10 (``dist/``) on the phase-3 rows and index, launch counts from
   0, on ``make_mesh(4, device="cuda:0")`` (four shards of one card; also
   ``make_mesh()`` over distinct cards where there are two or more):
   (a) ``build_ivf_index_distributed`` on 4 shards against 1 shard
   (centroids within 2e-5, assignments equal but at ties), served as phase
   3 serves its index at nprobe 8 (recall within 0.01 of phase 3's); (b)
   ``distributed_lloyd`` from the single build's initial centroids against
   ``_lloyd`` (assignments equal but at ties; K1 once a shard an
   iteration), and K1 at shard 0's shapes against its plain version (ids
   equal but at near ties); (c) ``DistributedIvfSearcher`` on bf16 storage
   with its f32 copy at phase 3's nprobe: ``search_fused`` (K3 on each
   shard) with every slot at least as near as the single-device
   ``search(stream)``'s (each shard fetches 2k), the f32 searcher's ids
   equal to the f32 single ``search(stream)``'s, and both searchers'
   gather chains' ids equal to their ``search_fused``'s, but at ties;
   ``search_binscan``, ``search_binscan8`` (K7), ``search_scan`` and,
   calibrated, ``search_bincompact`` (K8) at recall >= 0.95; K7 (bf16,
   int8) and K8 at shard 0's shapes against their plain versions as phase
   2b holds them, K8 on the searcher's own tile selection at the
   calibrated cap and at nprobe 1 with half the shard's tiles (then run
   through ``search_bincompact``); ``DistributedExactSearcher`` (K2 on each shard)
   equal to the K2 truth; the 2 x 2 ``DistributedClusterIvfSearcher`` with the
   1-D mesh's ids; ``with_spill(0.2)`` with no repeated id; each kernel
   launched once a shard a call; ms a batch at 1 and 4 shards beside the
   single-device searcher; then 1,000 deletes and 256 appends, after which
   no deleted id comes back and each query's appended copy is first.
   ``scripts/torch_dist_check.py`` runs this phase alone.

11. Slice 11 on the phase-3 file in its original row order (bf16 storage
   with its f32 copy), launch counts from 0: ``exact`` with ``xbin``,
   ``xbin8`` and ``tilescan`` at B = 256 (recall@10 against the K2 truth,
   each returned distance its row's exact distance, ms a batch beside K7
   ``binscan`` and the bf16 ``mm`` + row-min floor), ``xbin`` and
   ``tilescan`` again at B = 4096 through their chunked branch (step count
   printed; its first 256 queries give the B = 256 ids, but at ties);
   ``autoscan``: the default prober's weather report on the card and its
   route, then an injected healthy report (``search(scan)``'s ids, no K7
   launch) and a degraded one (``search(binscan)``'s ids, K7 launched);
   ``search_loop(binscan8)`` (K7), ``exact_loop(xbin8)`` and, on the sorted
   bf16 searcher, ``search_loop(stream)`` (K3), reps 4, under
   ``loop_rescore`` "body" and "defer", the deferred result equal to the
   2k storage-precision selection re-scored once, with ``_hbm_bytes()`` and
   the ``auto`` decision; ``search_xbin`` and ``search_xbin8`` on four
   shards of the card (recall, exact distances, ms a batch).
   ``scripts/torch_slice11_check.py`` runs this phase alone.

The last lines are the tiles and chunks K4, K3 and K6 scored of those a
full walk scores, the front doors' line, slice 9's, slice 10's and slice
11's lines, the script's, phase 10's and phase 11's seconds, the kernels'
JSON (with each kernel's launches in phases 9, 10 and 11), the card's name
and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
ROWS, DIM, N_CLUSTERS, K, BATCH = 1_000_000, 128, 1024, 10, 256
ROW_TILE = 4096  # the bench's searcher layout (bench.py:572-590)
RECALL_TARGET = 0.95
KERNELS = {
    "K1": ("assign", "pqvector_tpu_torch/csrc/assign.cu",
           "pqvector_tpu/kernels/assign.py:45"),
    "K2": ("stream_exact_topk", "pqvector_tpu_torch/csrc/stream_topk.cu",
           "pqvector_tpu/kernels/stream_topk.py:239"),
    "K3": ("stream_masked_topk", "pqvector_tpu_torch/csrc/stream_topk.cu",
           "pqvector_tpu/kernels/stream_topk.py:325"),
    "K4": ("masked_local_topk", "pqvector_tpu_torch/csrc/scan_topk.cu",
           "pqvector_tpu/kernels/scan_topk.py:234"),
    "K5": ("exact_topk", "pqvector_tpu_torch/csrc/scan_topk.cu",
           "pqvector_tpu/kernels/scan_topk.py:188"),
    "K6": ("masked_topk", "pqvector_tpu_torch/csrc/scan_topk.cu",
           "pqvector_tpu/kernels/scan_topk.py:294"),
    "K7": ("binned_scan", "pqvector_tpu_torch/csrc/binscan.cu",
           "pqvector_tpu/kernels/binscan.py:242"),
    "K8": ("binned_scan_select", "pqvector_tpu_torch/csrc/binscan.cu",
           "pqvector_tpu/kernels/binscan.py:402"),
    "K9": ("tile_min", "pqvector_tpu_torch/csrc/tilemin.cu",
           "pqvector_tpu/kernels/tilemin.py:90"),
    "K10": ("tile_gather", "pqvector_tpu_torch/csrc/compact.cu",
            "pqvector_tpu/kernels/compact.py:133"),
    "K11": ("tile_gather_dma", "pqvector_tpu_torch/csrc/compact.cu",
            "pqvector_tpu/kernels/compact.py:76"),
}
_BUILD = None  # pqvector_tpu_torch.kernels._build, once main has imported it
DEEP_ROWS, DEEP_DIM, DEEP_CLUSTERS = 10_000_000, 96, 4096
DEVICE = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()``, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# --------------------------------------------------------------------------
# Comparisons


def compare_topk(got, want, q, x, sq, tol_scale=1e-5):
    """Compare two (partial d² [B, k], ids [B, k]) selections, both sorted by
    (distance, id): d² within ``tol_scale * (|q|^2 + max |x|^2)``, and every
    differing id a near-tie, its exact partial distance (float64 from the
    stored values) within that tolerance of the other pick's. The kernel and
    cuBLAS sum the products in different orders, so f32 scores can differ in
    the last bits. Returns (max |d² difference| over real slots, number of
    swapped ids)."""
    gd, gi = (t.cpu().numpy() for t in got)
    wd, wi = (t.cpu().numpy() for t in want)
    real = (wi >= 0) & (gi >= 0)
    check(np.array_equal(wi >= 0, gi >= 0), "empty slots differ")
    err = float(np.abs(gd - wd)[real].max()) if real.any() else 0.0
    qn = (q.astype(np.float64) ** 2).sum(1)
    tol = tol_scale * (qn + float(sq[sq < 1e38].max()))
    check(err <= float(tol.max()), f"distance error {err} over tolerance")
    rows, cols = np.nonzero(gi != wi)
    for b, j in zip(rows, cols):
        pg = sq[gi[b, j]] - 2.0 * q[b].astype(np.float64) @ x[gi[b, j]]
        pw = sq[wi[b, j]] - 2.0 * q[b].astype(np.float64) @ x[wi[b, j]]
        check(abs(pg - pw) <= tol[b], f"query {b}: ids {gi[b, j]} vs {wi[b, j]} are no tie")
    return err, int(rows.size)


def stored_f64(t):
    """A device tensor as the float64 values it stores."""
    return t.float().cpu().numpy().astype(np.float64)


# --------------------------------------------------------------------------
# Phase 2a: small awkward shapes, exact agreement


def grid_layout(n, d, kc, tile, seed, nq=37, shuffle=False):
    """Rows on a 1/4 grid sorted by cluster, so every score is exact in f32
    and bf16 and many distances tie; pad rows carry +3e38. ``shuffle`` stores
    the rows in random order instead: a tile then holds rows of most clusters
    and the slots of its rows are unsorted."""
    rng = np.random.default_rng(seed)
    cent = rng.integers(-8, 9, (kc, d)).astype(np.float32) / 4
    lab = np.sort(rng.integers(0, kc, n))
    if shuffle:
        lab = lab[np.random.default_rng(seed + 1).permutation(n)]
    x = cent[lab] + rng.integers(-2, 3, (n, d)).astype(np.float32) / 4
    n_pad = -(-(n + 1) // tile) * tile
    emb = np.zeros((n_pad, d), np.float32)
    emb[:n] = x
    sq = np.full(n_pad, 3.0e38, np.float32)
    sq[:n] = (x * x).sum(1)
    rc = np.full(n_pad, kc, np.int32)
    rc[:n] = lab
    parts = rc.reshape(-1, tile)
    uniques = [np.unique(p) for p in parts]
    tc = np.full((len(parts), max(u.size for u in uniques)), kc, np.int32)
    lcl = np.zeros(parts.shape, np.int32)
    for t, u in enumerate(uniques):
        tc[t, : u.size] = u
        lcl[t] = np.searchsorted(u, parts[t])
    q = x[rng.integers(0, n, nq)] + rng.integers(-1, 2, (nq, d)).astype(np.float32) / 4
    return cent, emb, sq, lcl.reshape(-1), tc, q


def phase2_small(torch, st, sc, ka):
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    base = rng.integers(-4, 5, (23, 40)).astype(np.float32)
    cent = torch.from_numpy(np.concatenate([base, base, base])).to(dev)  # ties
    x = torch.from_numpy(
        base[rng.integers(0, 23, 1001)] + rng.integers(-1, 2, (1001, 40)).astype(np.float32)
    ).to(dev)
    got = ka.assign_rows(x, cent)
    check(torch.equal(got, ka.assign_rows_plain(x, cent)), "K1 small: ids differ")
    check(int(got.max()) < 23, "K1 small: ties did not go to the lowest index")
    log("phase 2a K1: 1001 x 40, k=69 with tripled centroids: exact")
    cases = 0
    for n, tile, k in ((5000, 256, 1), (5000, 256, 128), (5, 256, 9), (700, 64, 10)):
        cent_np, emb, sq, lcl, tc, q = grid_layout(n, 72, 20, tile, seed=n + k)
        for dt in (torch.float32, torch.bfloat16):
            E = torch.from_numpy(emb).to(dev).to(dt)
            S = torch.from_numpy(sq).to(dev)
            L = torch.from_numpy(lcl).to(dev)
            TC = torch.from_numpy(tc).to(dev)
            C = torch.from_numpy(cent_np).to(dev)
            Q = torch.from_numpy(q).to(dev)
            qf = Q.to(dt)
            exact = (st.stream_exact_scan(qf, E, S, k, tile),
                     st.stream_exact_scan_plain(qf, E, S, k))
            mask = st._probe_mask(Q, C, (C * C).sum(1), 3, 20, 128)
            sched = st._tile_schedule(mask, TC)
            args = (qf, E, S, L, TC, mask, sched, k, tile)
            masked = (st.stream_masked_scan(*args), st.stream_masked_scan_plain(*args))
            lmask = mask[:, TC.long()].permute(1, 0, 2).contiguous()
            args = (qf, E, S, L, lmask, k, tile)
            local = (sc.masked_local_scan(*args), sc.masked_local_scan_plain(*args))
            torch.cuda.synchronize()
            for name, (g, w) in (("K2", exact), ("K3", masked), ("K4", local)):
                check(torch.equal(g[1], w[1]) and torch.equal(g[0], w[0]),
                      f"{name} small n={n} k={k} {dt}: differs from plain")
                cases += 1
    log(f"phase 2a K2/K3/K4: {cases} cases (k=1..128, n<k, pad rows, f32/bf16): exact")


def phase2_k6_score_tile(torch, st, sc):
    """K6 on the score tile against its plain version on 1/4-grid data in
    file order (rows in random order, so a tile holds rows of most
    clusters), equal bit for bit on both back ends: B not a multiple of 64
    or 128, k = 1 to 128, widths that end inside a stage, n < k, pad rows,
    a tile shorter than a chunk and one of 64 chunks, one cluster and 20000
    (a probe table too wide for shared memory, as at k = 128 on wgmma); the
    kernel's counters of scored tiles and chunks equal to
    ``masked_scan_chunks``'. -> cases."""
    dev = torch.device(DEVICE)
    cases = mma = tableless = 0
    # (n, tile, k, d, B, clusters)
    for n, tile, k, d, b, kc in (
            (5000, 256, 128, 72, 128, 20), (3000, 1024, 10, 96, 129, 20),
            (3000, 1024, 10, 100, 257, 7), (700, 64, 10, 8, 37, 20),
            (5, 256, 9, 136, 5, 3), (20000, 8192, 10, 16, 13, 40),
            (9000, 1024, 100, 128, 130, 300), (4000, 512, 1, 3, 1, 9),
            (6000, 1024, 64, 40, 65, 50), (3000, 512, 128, 24, 70, 20000),
            (600, 128, 5, 40, 3, 1)):
        cent_np, emb, sq, lcl, tc, q = grid_layout(n, d, kc, tile, seed=n + k + d + 1,
                                                   nq=b, shuffle=True)
        rc = tc[np.arange(emb.shape[0]) // tile, lcl]  # row -> cluster, kc on pad rows
        kc_pad = -(-(kc + 1) // 128) * 128
        for dt in (torch.float32, torch.bfloat16):
            E = torch.from_numpy(emb).to(dev).to(dt)
            S = torch.from_numpy(sq).to(dev)
            RC = torch.from_numpy(rc).to(dev)
            C = torch.from_numpy(cent_np).to(dev)
            Q = torch.from_numpy(q).to(dev)
            qf = Q.to(dt)
            mask = st._probe_mask(Q, C, (C * C).sum(1), min(3, kc), min(20, kc), kc_pad)
            backend, queries, words, _ = sc.masked_geometry("K6", qf, E, k, kc_pad)
            rule = sc.masked_scan_chunks(mask, RC, tile, queries, table=bool(words))
            want_stats = [int(rule.any(2).sum()), int(rule.sum())]
            stats = torch.zeros(2, dtype=torch.int32, device=dev)
            args = (qf, E, S, RC, mask, k, tile)
            g, w = sc.masked_scan(*args, stats=stats), sc.masked_scan_plain(*args)
            torch.cuda.synchronize()
            what = f"K6 small n={n} tile={tile} k={k} d={d} B={b} kc={kc} {dt}"
            check(torch.equal(g[1], w[1]) and torch.equal(g[0], w[0]),
                  f"{what}: {int((g[1] != w[1]).sum())} ids differ from plain")
            check(stats.tolist() == want_stats,
                  f"{what}: scored {stats.tolist()} tiles and chunks, the rule says "
                  f"{want_stats}")
            cases += 1
            mma += backend == "wgmma"
            tableless += not words
    log(f"phase 2a K6, score tile: {cases} cases (k 1..128, B 1..257, d 3..136, tile "
        f"64..8192, n < k, pad rows, file order, 1..20000 clusters, f32/bf16): ids and "
        f"distances equal to the plain version, scored tiles and chunks equal to the "
        f"rule's; {mma} on wgmma, {tableless} without the probe table in shared memory")
    return cases


def phase2_binscan_score_tile(torch, bs, quantize):
    """K7 and K8 on the score tile against their plain versions on 1/4-grid
    data, key tables equal bit for bit on every back end: wgmma (bf16,
    d % 8 == 0), the fp32 patch (f32; bf16 of d = 100) and the dp4a patch
    (int8, d = 33 and 200), each with 64 queries a block (B <= 64) and 128;
    expand 1, 2 and 4, fewer selected slots than tiles, a partial last tile
    group. -> cases."""
    dev = torch.device(DEVICE)
    cases = 0
    seen = set()
    # (n, d, tile, expand, dtype, slots selected or None, B)
    for n, d, tile, expand, dt, n_sel, b in (
            (5000, 64, 256, 1, "bf16", None, 13), (5000, 128, 256, 2, "bf16", None, 129),
            (9000, 72, 256, 4, "bf16", 9, 257), (6000, 100, 256, 2, "bf16", None, 65),
            (6000, 100, 256, 1, "bf16", 9, 3), (5000, 40, 128, 4, "f32", None, 37),
            (7000, 96, 512, 2, "f32", 10, 200), (3000, 3, 128, 1, "f32", None, 64),
            (6000, 33, 512, 2, "int8", 9, 77), (3000, 200, 256, 1, "int8", None, 20),
            (8000, 128, 256, 4, "int8", 11, 130), (4000, 64, 128, 2, "int8", None, 1)):
        emb, sq, q = grid_rows(n, d, tile, seed=n + d + tile + b, nq=b)
        E32 = torch.from_numpy(emb).to(dev)
        S = torch.from_numpy(sq).to(dev)
        Q = torch.from_numpy(q).to(dev)
        scale = None
        if dt == "int8":
            E, scale = quantize(E32)
        else:
            E = E32.to(torch.bfloat16 if dt == "bf16" else torch.float32)
        nt = emb.shape[0] // tile
        back = bs.backend(E, Q.to(E.dtype) if dt != "int8" else Q)
        if n_sel is None:
            got = bs.binned_scan_keys(Q, E, S, tile, expand, scale)
            want = bs.binned_scan_keys_plain(Q, E, S, tile, expand, scale)
        else:
            sel = torch.from_numpy(
                np.random.default_rng(n_sel).permutation(nt)[:n_sel].astype(np.int32)
            ).to(dev)
            got = bs.binned_scan_select_keys(Q, E, S, sel, tile, expand, scale)
            want = bs.binned_scan_select_keys_plain(Q, E, S, sel, tile, expand, scale)
        torch.cuda.synchronize()
        name = "K7" if n_sel is None else "K8"
        check(torch.equal(got, want),
              f"{name} score tile n={n} d={d} tile={tile} expand={expand} {dt} B={b} "
              f"({back}): {int((got != want).sum())} keys differ from plain")
        check(bool((got != 2**31 - 1).all()), f"{name} score tile: a bin was never touched")
        seen.add((back, 64 if back != "wgmma" and b <= 64 else 128))
        cases += 1
    check(len(seen) == 5, f"K7/K8 score tile cases missed a back end: {sorted(seen)}")
    log(f"phase 2a K7/K8, score tile: {cases} cases (wgmma, fp32 and dp4a patches of 64 "
        f"and 128 queries, d 3..200, B 1..257, expand 1/2/4, fewer selected slots than "
        f"tiles): key tables equal to the plain versions")
    return cases


def grid_rows(n, d, tile, seed, nq=13):
    """Rows on a 1/4 grid with many ties, padded to a multiple of ``tile``
    (+3e38 norms on pad rows), and ``nq`` queries near them."""
    rng = np.random.default_rng(seed)
    base = rng.integers(-8, 9, (17, d)).astype(np.float32) / 4
    x = base[rng.integers(0, 17, n)] + rng.integers(-2, 3, (n, d)).astype(np.float32) / 4
    n_pad = -(-(n + 1) // tile) * tile
    emb = np.zeros((n_pad, d), np.float32)
    emb[:n] = x
    sq = np.full(n_pad, 3.0e38, np.float32)
    sq[:n] = (x * x).sum(1)
    q = x[rng.integers(0, n, nq)] + rng.integers(-1, 2, (nq, d)).astype(np.float32) / 4
    return emb, sq, q


def phase2_small_slice2(torch, st, sc, bs, quantize):
    """K5-K8 against their plain versions at small awkward shapes: exact."""
    dev = torch.device(DEVICE)
    cases = 0
    for n, tile, k in ((5000, 256, 1), (5000, 256, 128), (5, 256, 9), (700, 64, 10)):
        cent_np, emb, sq, lcl, tc, q = grid_layout(n, 72, 20, tile, seed=n + k + 1)
        rc = tc[np.arange(emb.shape[0]) // tile, lcl]  # row -> cluster, 20 on pad rows
        perm = np.random.default_rng(k).permutation(n)  # K6 runs on file order
        emb[:n], sq[:n], rc[:n] = emb[perm], sq[perm], rc[perm]
        for dt in (torch.float32, torch.bfloat16):
            E = torch.from_numpy(emb).to(dev).to(dt)
            S = torch.from_numpy(sq).to(dev)
            RC = torch.from_numpy(rc).to(dev)
            C = torch.from_numpy(cent_np).to(dev)
            Q = torch.from_numpy(q).to(dev)
            qf = Q.to(dt)
            mask = st._probe_mask(Q, C, (C * C).sum(1), 3, 20, 128)
            pairs = (
                ("K5", sc.exact_scan(qf, E, S, k, tile), sc.exact_scan_plain(qf, E, S, k, tile)),
                ("K6", sc.masked_scan(qf, E, S, RC, mask, k, tile),
                 sc.masked_scan_plain(qf, E, S, RC, mask, k, tile)),
            )
            torch.cuda.synchronize()
            for name, g, w in pairs:
                check(torch.equal(g[1], w[1]) and torch.equal(g[0], w[0]),
                      f"{name} small n={n} k={k} {dt}: differs from plain")
                cases += 1
    log(f"phase 2a K5/K6: {cases} cases (k=1..128, n<k, pad rows, f32/bf16, file order): exact")
    cases = 0
    # (n, d, tile, expand, dtype, slots selected or None, k)
    for n, d, tile, expand, dt, n_sel, k in (
        (5000, 72, 256, 1, "f32", None, 10),
        (5000, 72, 256, 2, "bf16", None, 10),
        (5000, 72, 128, 4, "int8", None, 1),
        (100, 40, 128, 1, "f32", None, 120),  # n < k, k near the 128 bins
        (6000, 64, 256, 1, "bf16", 5, 16),
        (6000, 33, 512, 2, "int8", 9, 5),  # d % 4 != 0
        (3000, 200, 256, 1, "int8", None, 7),  # two int8 staging steps
        (3000, 200, 256, 2, "f32", 7, 7),
    ):
        emb, sq, q = grid_rows(n, d, tile, seed=n + d + tile)
        E32 = torch.from_numpy(emb).to(dev)
        S = torch.from_numpy(sq).to(dev)
        Q = torch.from_numpy(q).to(dev)
        scale = None
        if dt == "int8":
            E, scale = quantize(E32)
        else:
            E = E32.to(torch.bfloat16 if dt == "bf16" else torch.float32)
        nt = emb.shape[0] // tile
        if n_sel is None:
            got = bs.binned_scan_keys(Q, E, S, tile, expand, scale)
            want = bs.binned_scan_keys_plain(Q, E, S, tile, expand, scale)
            d2, ids = bs.binned_scan(Q, E, S, k, tile, expand, scale, E32)
        else:
            sel = torch.from_numpy(
                np.random.default_rng(n_sel).permutation(nt)[:n_sel].astype(np.int32)
            ).to(dev)
            got = bs.binned_scan_select_keys(Q, E, S, sel, tile, expand, scale)
            want = bs.binned_scan_select_keys_plain(Q, E, S, sel, tile, expand, scale)
            d2, ids = bs.binned_scan_select(Q, E, S, sel, k, tile, expand, scale, E32)
        torch.cuda.synchronize()
        name = "K7" if n_sel is None else "K8"
        check(torch.equal(got, want),
              f"{name} small n={n} d={d} tile={tile} expand={expand} {dt}: "
              f"{int((got != want).sum())} keys differ from plain")
        check(bool((got != 2**31 - 1).all()), f"{name} small: a bin was never touched")
        check(d2.shape == (13, k) and ids.shape == (13, k), f"{name} small: bad shape")
        cases += 1
    log(f"phase 2a K7/K8: {cases} cases (f32/bf16/int8, expand 1/2/4, k near the "
        "bins, n < k, fewer selected slots than tiles, d % 4 != 0): key tables exact")


def compare_keys(got, want, tol, code_bits):
    """Two key tables over the same candidates: every bin's value (the key
    with its ``code_bits`` provenance bits cleared) within ``tol`` plus two
    steps of the value's truncation of the other's. Where the kernel and
    cuBLAS sum the products in other orders, a value may round across a
    truncation step, and a bin may keep another of two near-tied rows.
    Returns (max |value difference|, bins whose keys differ)."""
    g, w = got.cpu().numpy(), want.cpu().numpy()
    hi = ~np.int32((1 << code_bits) - 1)
    gv = (g & hi).view(np.float32).astype(np.float64)
    wv = (w & hi).view(np.float32).astype(np.float64)
    real = wv < 1e38
    check(np.array_equal(real, gv < 1e38), "key tables: pad-only bins differ")
    diff = np.abs(gv - wv)[real]
    bound = tol + 2.0 ** (code_bits - 22) * np.maximum(np.abs(gv), np.abs(wv))[real]
    check(bool((diff <= bound).all()),
          f"key values differ beyond the tolerance (max {float(diff.max())})")
    return float(diff.max()), int((g != w).sum())


def compare_tables(got, want, q64, x_sq, code_bits):
    """``compare_keys`` at compare_topk's f32 tolerance."""
    tol = 1e-5 * (float((q64 ** 2).sum(1).max()) + float(x_sq[x_sq < 1e38].max()))
    return compare_keys(got, want, tol, code_bits)


def binned_library_ms(torch, q, emb, bins):
    """The two-call chain a user would write for a binned minimum: a bf16
    product, then ``scatter_reduce(amin)`` of its columns into ``bins``
    (row r -> bin r % bins); values only, no norms and no packed keys."""
    q2 = (-2.0 * q).to(emb.dtype)
    idx = (torch.arange(emb.shape[0], device=q.device) % bins)[None, :].expand(
        q.shape[0], -1).contiguous()

    def chain():
        table = torch.full((q.shape[0], bins), torch.inf, dtype=emb.dtype, device=q.device)
        return table.scatter_reduce_(1, idx, q2 @ emb.T, "amin")

    return time_ms(chain)


def binned_library_ms_i8(torch, bs, q, e8, scale, bins):
    """The int8 form of that chain: ``torch._int_mm`` of the int8 query codes
    by the int8 row codes (int32 sums), the per-query and per-row scales,
    then ``scatter_reduce(amin)`` into ``bins``; values only."""
    q8, qs = bs.quantize_queries_i8(q)
    e8t = e8.T  # column-major, as _int_mm's second operand takes it
    idx = (torch.arange(e8.shape[0], device=q.device) % bins)[None, :].expand(
        q.shape[0], -1).contiguous()

    def chain():
        prod = torch._int_mm(q8, e8t).float() * (-2.0 * qs[:, None]) * scale[None, :]
        table = torch.full((q.shape[0], bins), torch.inf, device=q.device)
        return table.scatter_reduce_(1, idx, prod, "amin")

    return time_ms(chain)


def phase2b_slice2(torch, pqt, sc, st, bs, compact_select, index_a, emb_np, s16, q,
                   q16, tile, results):
    """K6, K7 and K8 at the main path's shapes against their plain versions,
    timed: K6 and K7 on the bf16 layout in file order, K8 on the sorted one."""
    dev = q.device
    fo16 = pqt.DeviceIvfSearcher(index_a, emb_np, dtype=torch.bfloat16,
                                 row_tile=ROW_TILE, device=dev)
    qf16 = q.to(torch.bfloat16)
    nprobe_2b = 8
    kc_pad = -(-(N_CLUSTERS + 1) // 128) * 128
    mask = st._probe_mask(q, fo16.centroids, fo16.c_sq, nprobe_2b,
                          fo16._max_probe_bucket(nprobe_2b), kc_pad)
    xf, sqf = stored_f64(fo16.emb), fo16._pallas_emb_sq().cpu().numpy().astype(np.float64)
    m_args = (qf16, fo16.emb, fo16._pallas_emb_sq(), fo16.row_cluster, mask, K, tile)
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    err, swaps = compare_topk(sc._final_merge(*sc.masked_scan(*m_args, stats=stats), K),
                              sc._final_merge(*sc.masked_scan_plain(*m_args), K),
                              q16, xf, sqf)
    backend, queries, words, _ = sc.masked_geometry("K6", qf16, fo16.emb, K, kc_pad)
    rule = sc.masked_scan_chunks(mask, fo16.row_cluster, tile, queries, table=bool(words))
    want_stats = [int(rule.any(2).sum()), int(rule.sum())]
    check(stats.tolist() == want_stats,
          f"phase 2b K6: scored {stats.tolist()} (block, tile) and (block, chunk) pairs, "
          f"the rule says {want_stats}")
    results["K6"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: sc.masked_scan(*m_args)),
        "plain_ms": time_ms(lambda: sc.masked_scan_plain(*m_args)),
        "scored": {"backend": backend, "table_words": words,
                   "block_tiles": rule.shape[0] * rule.shape[1],
                   "block_tiles_scored": want_stats[0], "block_chunks": rule.numel(),
                   "block_chunks_scored": want_stats[1]},
    }
    log(f"phase 2b K6 bf16 file order, nprobe={nprobe_2b}: {swaps} near-tie swaps "
        f"after the merge, max err {err:.3g}; blocks of {queries} queries on {backend} "
        f"scored {want_stats[0]} of {rule.shape[0] * rule.shape[1]} (block, tile) and "
        f"{want_stats[1]} of {rule.numel()} (block, chunk) pairs, as the rule says; "
        f"kernel {results['K6']['ms']:.3f} ms, "
        f"plain {results['K6']['plain_ms']:.3f} ms")
    n_pad = fo16.emb.shape[0]
    row_bytes, ops = probed_work(torch, mask, fo16.row_cluster, DIM, 2)
    results["K6"].update(
        bound_of(row_bytes + nbytes_of(qf16, mask) + (n_pad // tile) * BATCH * K * 8, ops,
                 "bf16"),
        library_ms=masked_library_ms(torch, qf16, fo16.emb, fo16._pallas_emb_sq(),
                                     fo16.row_cluster, mask, K, reps=5))
    del xf

    q64 = q.double().cpu().numpy()
    sq64 = fo16._pallas_emb_sq().cpu().numpy().astype(np.float64)
    t7 = fo16._binscan_tile()
    e7 = fo16._binscan_expand(t7)
    nt = fo16.emb.shape[0] // t7
    cb = bs.provenance_bits(nt, t7)
    k_args = (q, fo16.emb, fo16._pallas_emb_sq(), t7, e7)
    err, swaps = compare_tables(bs.binned_scan_keys(*k_args),
                                bs.binned_scan_keys_plain(*k_args), q64, sq64, cb)
    results["K7"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: bs.binned_scan_keys(*k_args)),
        "plain_ms": time_ms(lambda: bs.binned_scan_keys_plain(*k_args)),
    }
    log(f"phase 2b K7 bf16 file order, tile={t7}, expand={e7}, {cb} provenance bits: "
        f"{swaps} of {e7 * t7 * BATCH} bins hold another near-tied row, max value err "
        f"{err:.3g}; kernel {results['K7']['ms']:.3f} ms, plain "
        f"{results['K7']['plain_ms']:.3f} ms")
    results["K7"].update(
        bound_of(nbytes_of(q, fo16.emb, fo16._pallas_emb_sq()) + e7 * t7 * BATCH * 4,
                 2.0 * BATCH * n_pad * DIM, "bf16"),
        library_ms=binned_library_ms(torch, q, fo16.emb, e7 * t7))
    log(f"phase 2b K6/K7: bound {results['K6']['bound_ms']:.3f} / "
        f"{results['K7']['bound_ms']:.3f} ms ({results['K6']['bound_by']} / "
        f"{results['K7']['bound_by']}); K6's mm + gathered mask + topk "
        f"{results['K6']['library_ms']:.3f} ms, K7's mm + scatter_reduce(amin) "
        f"{results['K7']['library_ms']:.3f} ms")
    e8, sc8 = fo16._xbin8_arrays()
    t8 = fo16._binscan_tile(esize=1)
    i8_args = (q, e8, fo16._pallas_emb_sq(), t8, fo16._binscan_expand(t8, esize=1), sc8)
    check(torch.equal(bs.binned_scan_keys(*i8_args), bs.binned_scan_keys_plain(*i8_args)),
          "K7 int8: key table differs from plain")
    ms8 = time_ms(lambda: bs.binned_scan_keys(*i8_args))
    plain8 = time_ms(lambda: bs.binned_scan_keys_plain(*i8_args))
    results["K7"]["int8_ms"], results["K7"]["int8_plain_ms"] = ms8, plain8
    lib8 = binned_library_ms_i8(torch, bs, q, e8, sc8,
                                fo16._binscan_expand(t8, esize=1) * t8)
    results["K7"]["int8_library_ms"] = lib8
    log(f"phase 2b K7 int8, tile={t8}: key table identical to plain; kernel "
        f"{ms8:.3f} ms, plain {plain8:.3f} ms, _int_mm + scales + scatter_reduce(amin) "
        f"{lib8:.3f} ms")
    del fo16, e8, sc8

    ctile, cap = s16.calibrate_bincompact(q, nprobe_2b, K)
    check(ctile > 0, "bincompact ineligible at the main shape")
    tlo, thi, span = s16._compact_tile_ranges(ctile)
    n_pad = s16.emb.shape[0]
    sel = compact_select(q, s16.centroids, s16.c_sq, s16.row_cluster, nprobe_2b,
                         s16._compact_probe_bucket(nprobe_2b), ctile, cap, tlo, thi,
                         span, n_pad)
    cb = bs.provenance_bits(cap, ctile)
    s_args = (q, s16.emb, s16._pallas_emb_sq(), sel, ctile,
              s16._binscan_expand(ctile, cap=cap))
    sq64 = s16._pallas_emb_sq().cpu().numpy().astype(np.float64)
    err, swaps = compare_tables(bs.binned_scan_select_keys(*s_args),
                                bs.binned_scan_select_keys_plain(*s_args), q64, sq64, cb)
    results["K8"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: bs.binned_scan_select_keys(*s_args)),
        "plain_ms": time_ms(lambda: bs.binned_scan_select_keys_plain(*s_args)),
    }
    log(f"phase 2b K8 bf16 sorted, nprobe={nprobe_2b}, tile={ctile}, cap={cap} of "
        f"{n_pad // ctile} tiles: {swaps} bins hold another near-tied row, max value "
        f"err {err:.3g}; kernel {results['K8']['ms']:.3f} ms, plain "
        f"{results['K8']['plain_ms']:.3f} ms")
    rows8 = cap * ctile
    gathered = s16.emb.view(-1, ctile, DIM)[sel.long()].reshape(rows8, DIM)
    e_sel = s16._binscan_expand(ctile, cap=cap)
    results["K8"].update(
        bound_of(rows8 * (DIM * 2 + 4) + cap * 4 + nbytes_of(q)
                 + e_sel * ctile * BATCH * 4, 2.0 * BATCH * rows8 * DIM, "bf16"),
        library_ms=binned_library_ms(torch, q, gathered, e_sel * ctile))
    log(f"phase 2b K8: bound {results['K8']['bound_ms']:.3f} ms "
        f"({results['K8']['bound_by']}); mm + scatter_reduce(amin) over the gathered "
        f"rows {results['K8']['library_ms']:.3f} ms")
    del gathered
    e8, sc8 = s16._xbin8_arrays()
    i8_args = (q, e8, s16._pallas_emb_sq(), sel, ctile,
               s16._binscan_expand(ctile, cap=cap, esize=1), sc8)
    check(torch.equal(bs.binned_scan_select_keys(*i8_args),
                      bs.binned_scan_select_keys_plain(*i8_args)),
          "K8 int8: key table differs from plain")
    ms8 = time_ms(lambda: bs.binned_scan_select_keys(*i8_args))
    plain8 = time_ms(lambda: bs.binned_scan_select_keys_plain(*i8_args))
    results["K8"]["int8_ms"], results["K8"]["int8_plain_ms"] = ms8, plain8
    e_sel8 = s16._binscan_expand(ctile, cap=cap, esize=1)
    lib8 = binned_library_ms_i8(
        torch, bs, q, e8.view(-1, ctile, DIM)[sel.long()].reshape(rows8, DIM),
        sc8.view(-1, ctile)[sel.long()].reshape(rows8), e_sel8 * ctile)
    results["K8"]["int8_library_ms"] = lib8
    log(f"phase 2b K8 int8: key table identical to plain; kernel {ms8:.3f} ms, "
        f"plain {plain8:.3f} ms, _int_mm + scales + scatter_reduce(amin) over the "
        f"gathered rows {lib8:.3f} ms")
    s16._emb_i8 = s16._emb_i8_scale = None


def selection_ties(torch, got, want, q, emb, emb_sq, what):
    """Two re-scored top-k results selected over the same bf16 storage by
    kernels that may add the exact products in other orders (wgmma, fp32 FMA):
    rows both picked carry the same distance, and rows only one picked tie
    with the other's at the storage precision (their scores |x|^2 - 2 q.x
    over the stored values, in float64, within 1e-5 (|q|^2 + max |x|^2)).
    -> rows that differ."""
    gd, gi = got[0].double(), got[1].long()
    wd, wi = want[0].double(), want[1].long()
    both = (gi[:, :, None] == wi[:, None, :])  # [B, k, k]
    pair = both.nonzero()
    check(bool((gd[pair[:, 0], pair[:, 1]] == wd[pair[:, 0], pair[:, 2]]).all()),
          f"{what}: a row both picked has two distances")
    qs = q.to(emb.dtype).double()
    tol = 1e-5 * ((qs * qs).sum(1) + float(emb_sq[emb_sq < 1e38].max()))

    def scores(ids):  # [B, k] -> stored-precision scores
        rows = emb[ids.clamp_min(0)].double()
        return emb_sq[ids.clamp_min(0)].double() - 2.0 * (rows * qs[:, None, :]).sum(-1)

    only_g, only_w = ~both.any(2), ~both.any(1)
    check(torch.equal(only_g.sum(1), only_w.sum(1)), f"{what}: empty slots differ")
    sg = torch.where(only_g, scores(gi), torch.nan)
    sw = torch.where(only_w, scores(wi), torch.nan)
    spread = torch.fmax(sg.nan_to_num(-torch.inf).amax(1), sw.nan_to_num(-torch.inf).amax(1)) \
        - torch.fmin(sg.nan_to_num(torch.inf).amin(1), sw.nan_to_num(torch.inf).amin(1))
    spread = torch.where(only_g.any(1), spread, 0.0)
    check(bool((spread <= tol).all()),
          f"{what}: rows only one kernel picked are no tie (spread {float(spread.max())})")
    return int(only_g.sum())


def phase5(torch, pqt, _build, ds, path, q, queries, truth_np, sorted16, nprobe4, card):
    """Slice 2's path: K5 and K6 and K7 on the bf16 layout in file order,
    K8 on the sorted one, through the searcher's entry points."""
    t0 = time.perf_counter()
    fo = pqt.DeviceIvfSearcher.from_parquet(path, dtype=torch.bfloat16,
                                            row_tile=ROW_TILE, device=q.device)
    check(not fo._row_cluster_sorted, "from_parquet did not keep the file order")
    log(f"phase 5 bf16 searcher in file order from {os.path.basename(path)}: "
        f"{time.perf_counter() - t0:.2f} s")
    q32 = queries.astype(np.float64)
    x_sq = fo._pallas_emb_sq().cpu().numpy().astype(np.float64)
    out = {}
    _build.reset_launches()
    nprobe6, nprobe = None, 1
    while nprobe <= N_CLUSTERS:
        before = _build.LAUNCHES["K6"]
        d6, i6 = fo.search(q, K, nprobe, "pallas")
        check(_build.LAUNCHES["K6"] == before + 1, "search(pallas) did not take K6")
        r6 = ds.recall_at_k(truth_np, i6.cpu().numpy())
        log(f"phase 5 search pallas (K6, file order) nprobe={nprobe}: recall@{K} {r6:.4f}")
        if r6 >= RECALL_TARGET:
            nprobe6 = nprobe
            break
        nprobe *= 2
    check(nprobe6 is not None, f"K6 recall never reached {RECALL_TARGET}")
    same = int((sorted16.search(q, K, nprobe6, "pallas")[1] == i6).sum())
    out["pallas"] = {"nprobe": nprobe6, "recall_at_10": r6}
    log(f"phase 5 K6 on file order and K4 on the sorted layout at nprobe={nprobe6}: "
        f"{same} of {i6.numel()} ids equal (exact bf16 ties go to the lower resident "
        "id, and the layouts number rows differently)")

    before = _build.LAUNCHES["K5"]
    d5, i5 = fo.exact(q, K, "pallas")
    check(_build.LAUNCHES["K5"] == before + 1, "exact(pallas) did not take K5")
    swaps = selection_ties(torch, (d5, i5), fo.exact(q, K, "stream"), q, fo.emb,
                           fo._pallas_emb_sq(), "K5 vs K2")
    out["exact_pallas"] = {"recall_at_10": ds.recall_at_k(truth_np, i5.cpu().numpy()),
                           "swaps_vs_K2": swaps}
    log(f"phase 5 exact pallas (K5) vs stream (K2), both on wgmma over bf16: {swaps} rows "
        f"differ, each tied at the storage precision; recall@{K} against the f32 truth "
        f"{out['exact_pallas']['recall_at_10']:.4f}")

    for mode in ("binscan", "binscan8"):
        before = _build.LAUNCHES["K7"]
        d7, i7 = fo.search(q, K, 1, mode)
        check(_build.LAUNCHES["K7"] == before + 1, f"search({mode}) did not take K7")
        check(bool(torch.isfinite(d7).all()), f"{mode} returned empty slots")
        r7 = ds.recall_at_k(truth_np, i7.cpu().numpy())
        ex = fo.exact(q, K, mode)
        check(torch.equal(ex[1], i7), f"exact({mode}) and search({mode}) differ")
        out[mode] = {"recall_at_10": r7}
        log(f"phase 5 {mode} (K7, file order, tile={fo._binscan_tile(1 if mode[-1] == '8' else None)}): "
            f"recall@{K} {r7:.4f}")
    check(out["binscan"]["recall_at_10"] >= RECALL_TARGET,
          f"binscan recall {out['binscan']['recall_at_10']:.4f} < {RECALL_TARGET}")

    nprobe8 = nprobe4
    while True:
        ctile, cap = sorted16.calibrate_bincompact(queries, nprobe8, K)
        check(ctile > 0, f"bincompact ineligible at nprobe={nprobe8}")
        before = _build.LAUNCHES["K8"]
        d8, i8 = sorted16.search(q, K, nprobe8, "bincompact")
        check(_build.LAUNCHES["K8"] == before + 1, "search(bincompact) did not take K8")
        r8 = ds.recall_at_k(truth_np, i8.cpu().numpy())
        cov = cap / (sorted16.emb.shape[0] // ctile)
        log(f"phase 5 bincompact (K8, sorted) nprobe={nprobe8}: tile={ctile}, cap={cap}, "
            f"coverage {cov:.3f}, recall@{K} {r8:.4f}")
        if r8 >= RECALL_TARGET or nprobe8 >= 4 * nprobe4:
            break
        nprobe8 *= 2
    check(r8 >= RECALL_TARGET, f"bincompact recall {r8:.4f} < {RECALL_TARGET}")
    out["bincompact"] = {"nprobe": nprobe8, "recall_at_10": r8, "coverage": cov}
    d88, i88 = sorted16.search(q, K, nprobe8, "bincompact8")
    out["bincompact8"] = {"nprobe": nprobe8,
                          "recall_at_10": ds.recall_at_k(truth_np, i88.cpu().numpy())}
    log(f"phase 5 bincompact8 (K8 int8) nprobe={nprobe8}: recall@{K} "
        f"{out['bincompact8']['recall_at_10']:.4f}")
    out["launches"] = dict(_build.LAUNCHES)
    for name in ("K5", "K6", "K7", "K8"):
        check(out["launches"][name] > 0, f"{name} was not launched on slice 2's path")
    log(f"phase 5 launches on slice 2's path: {out['launches']}")

    timed = (
        ("pallas", lambda: fo.search(q, K, nprobe6, "pallas")),
        ("gather", lambda: fo.search(q, K, nprobe6, "gather")),
        ("exact_pallas", lambda: fo.exact(q, K, "pallas")),
        ("binscan", lambda: fo.search(q, K, 1, "binscan")),
        ("binscan8", lambda: fo.search(q, K, 1, "binscan8")),
        ("bincompact", lambda: sorted16.search(q, K, nprobe8, "bincompact")),
        ("bincompact8", lambda: sorted16.search(q, K, nprobe8, "bincompact8")),
    )
    for mode, fn in timed:
        ms = time_ms(fn)
        out.setdefault(mode, {}).update({"ms": ms, "qps": BATCH / (ms / 1000.0)})
        log(f"phase 5 {mode} B={BATCH}: {ms:.3f} ms/batch, {BATCH / (ms / 1000.0):.0f} QPS")
    out["auto_file_order"] = auto_route_table(fo, q, nprobe6, (1, 4, 16, 64, 256), 10,
                                              "phase 5")
    log(f"phase 5 on {card}")
    del fo
    torch.cuda.empty_cache()
    return out


def auto_route_table(s, q, nprobe, batches, reps, phase):
    """K6 against ``gather`` on a layout in file order at each batch size,
    and the route ``auto`` takes there: it must take the faster one unless
    the two are within 1.5x of each other."""
    out = []
    lmax = int(s.clusters.shape[1])
    for b in batches:
        qb = q[:b].contiguous()
        t6 = time_ms(lambda: s.search(qb, K, nprobe, "pallas"), reps=reps)
        tg = time_ms(lambda: s.search(qb, K, nprobe, "gather"), reps=reps)
        pick = s._unsorted_auto(b, nprobe)
        faster = "pallas" if t6 <= tg else "gather"
        check(pick == faster or max(t6, tg) <= 1.5 * min(t6, tg),
              f"{phase} B={b}: auto takes {pick}, but {faster} is faster "
              f"(K6 {t6:.3f} ms, gather {tg:.3f} ms)")
        out.append({"B": b, "K6_ms": t6, "gather_ms": tg,
                    "cand_over_n": b * nprobe * lmax / s.n, "auto": pick})
        log(f"{phase} file order B={b} nprobe={nprobe}: K6 {t6:.3f} ms, gather "
            f"{tg:.3f} ms, B*nprobe*lmax/n = {out[-1]['cand_over_n']:.4f}, auto takes "
            f"{pick}")
    return out


def phase6(torch, pqt, _build, ds, Embeddings, dev, cp, compact_select, tm, sc, st, ka):
    """The DEEP-shaped rung: 10M x 96, IVF-4096, bincompact and binscan."""
    import gc

    from pqvector_tpu_torch.kernels.binscan import provenance_bits

    t_phase = time.perf_counter()
    emb = ds.synthetic_embeddings(DEEP_ROWS, DEEP_DIM, seed=77, n_modes=1024)
    log(f"phase 6 generated {DEEP_ROWS} x {DEEP_DIM} in {time.perf_counter() - t_phase:.1f} s")
    _build.reset_launches()
    t0 = time.perf_counter()
    index = pqt.build_ivf_index(Embeddings(emb, DEEP_DIM),
                                pqt.IvfBuildConfig(n_clusters=DEEP_CLUSTERS), device=dev)
    torch.cuda.synchronize()
    out = {"rows": DEEP_ROWS, "dim": DEEP_DIM, "build_s": time.perf_counter() - t0}
    log(f"phase 6 IVF-{DEEP_CLUSTERS} built on the card in {out['build_s']:.2f} s")
    rng = np.random.default_rng(7)  # the prep's draw (scripts/deep10m_prep.py)
    q_all = emb[rng.integers(0, DEEP_ROWS, 4096)] + 0.05 * rng.standard_normal(
        (4096, DEEP_DIM)).astype(np.float32)
    q_dev = torch.from_numpy(q_all).to(dev)
    q256 = q_dev[:256].contiguous()
    t0 = time.perf_counter()
    truth_s = pqt.DeviceIvfSearcher(index, emb, row_tile=ROW_TILE, device=dev)
    truth_pair = truth_s.exact(q256, K)
    truth = truth_pair[1].cpu().numpy()
    check(truth.shape == (256, K) and (truth >= 0).all(), "deep truth has empty slots")
    del truth_s
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 6 f32 truth (K2) for 256 queries, searcher included: "
        f"{time.perf_counter() - t0:.1f} s")

    s = pqt.DeviceIvfSearcher(index, emb, dtype=torch.bfloat16, row_tile=ROW_TILE,
                              cluster_sorted=True, device=dev)
    res = None
    for nprobe in (4, 6, 8, 12, 16, 24, 32):
        ctile, cap = s.calibrate_bincompact(q_all[:256], nprobe, K)
        check(ctile > 0, f"deep bincompact ineligible at nprobe={nprobe}")
        _, ids = s.search(q256, K, nprobe, "bincompact")
        r = ds.recall_at_k(truth, ids.cpu().numpy())
        cov = cap / (s.emb.shape[0] // ctile)
        log(f"phase 6 bincompact nprobe={nprobe}: tile={ctile}, cap={cap}, coverage "
            f"{cov:.3f}, recall@{K} {r:.4f}")
        res = {"nprobe": nprobe, "recall_at_10": r, "coverage_b256": cov}
        if r >= RECALL_TARGET:
            break
    ms = time_ms(lambda: s.search(q256, K, res["nprobe"], "bincompact"), reps=5)
    res["qps_b256"] = 256 / (ms / 1000.0)
    out["bincompact"] = res
    log(f"phase 6 bincompact nprobe={res['nprobe']}: B=256 {ms:.2f} ms "
        f"({res['qps_b256']:.0f} QPS)")
    out["slice3"] = phase7b(torch, ds, cp, compact_select, s, q256, truth_pair)
    out["score_tile"] = deep_score_tile(torch, tm, sc, st, s, q256)
    out["masked"] = deep_masked(torch, sc, st, s, q256)
    out["assign"] = deep_assign(torch, ka, s)
    del s
    gc.collect()
    torch.cuda.empty_cache()

    s = pqt.DeviceIvfSearcher(index, emb, dtype=torch.bfloat16, row_tile=ROW_TILE,
                              device=dev)
    t7 = s._binscan_tile()
    _, ids = s.search(q256, K, 1, "binscan")
    r = ds.recall_at_k(truth, ids.cpu().numpy())
    ms = time_ms(lambda: s.search(q256, K, 1, "binscan"), reps=5)
    out["binscan"] = {"recall_at_10": r, "tile": t7, "expand": s._binscan_expand(t7),
                      "provenance_bits": provenance_bits(s.emb.shape[0] // t7, t7),
                      "qps_b256": 256 / (ms / 1000.0)}
    log(f"phase 6 binscan (file order, tile={t7}, expand={out['binscan']['expand']}, "
        f"{out['binscan']['provenance_bits']} provenance bits): recall@{K} {r:.4f}; "
        f"B=256 {ms:.2f} ms ({out['binscan']['qps_b256']:.0f} QPS)")
    out["launches"] = dict(_build.LAUNCHES)
    for name in ("K1", "K2", "K7", "K8", "K9", "K10", "K11"):
        check(out["launches"][name] > 0, f"{name} was not launched on the deep rung")
    out["auto_file_order"] = auto_route_table(s, q_dev, out["bincompact"]["nprobe"],
                                              (1, 16, 256), 5, "phase 6")
    del s, emb
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 6 launches {out['launches']}; {out['seconds']:.1f} s")
    return out


# --------------------------------------------------------------------------
# Bounds: the least time the card could take, from the H100's published peaks

PEAK = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}  # operations / s
PEAK_BYTES = 3.35e12  # bytes / s


def bound_of(nbytes: float, ops: float, kind: str) -> dict:
    """``bound_ms`` and ``bound_by`` for a call that must move ``nbytes``
    (inputs read once, outputs written once) and do ``ops`` operations of
    ``kind`` on the H100's published peaks."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --------------------------------------------------------------------------
# Slice 3: K9 tile min, K10 tile gather, K11 tile gather by bulk copies


def tile_min_cases(torch, tm, tiles, shapes, n_of):
    """K9 against its plain version on 1/4-grid rows and queries, where every
    product and sum is exact in f32 and in bf16 and the order of the sums
    cannot show: a partly padded tile, then one that is all pad rows, with
    +inf and +3e38 pads. -> (cases, cases that took the wgmma back end)."""
    from pqvector_tpu_torch.kernels.score_tile import pick_backend

    dev = torch.device(DEVICE)
    cases = mma = 0
    for tile in tiles:
        for d, b in shapes:
            for dt in (torch.float32, torch.bfloat16):
                for pad in (float("inf"), 3.0e38):
                    n = n_of(tile)
                    emb, sq, q = grid_rows(n, d, tile, seed=tile + d + b, nq=b)
                    emb = np.concatenate([emb, np.zeros((tile, d), np.float32)])
                    sq = np.concatenate([sq, np.full(tile, 3.0e38, np.float32)])
                    sq[sq > 1e38] = pad
                    E = torch.from_numpy(emb).to(dev).to(dt)
                    S = torch.from_numpy(sq).to(dev)
                    Q = torch.from_numpy(q).to(dev)
                    got = tm.tile_min(Q, E, S, tile)
                    want = tm.tile_min_plain(Q, E, S, tile)
                    torch.cuda.synchronize()
                    check(torch.equal(got, want),
                          f"K9 small tile={tile} d={d} B={b} {dt} pad={pad}: "
                          f"{int((got != want).sum())} of {got.numel()} differ, max err "
                          f"{float((got - want).abs().nan_to_num(0).max())}")
                    check(bool((got[:, -1] == pad).all()),
                          "K9 small: the all-pad tile did not return its sentinel")
                    cases += 1
                    mma += pick_backend(dt, d, E.data_ptr()) == "wgmma"
    return cases, mma


def phase2_small_k9(torch, tm):
    cases, mma = tile_min_cases(
        torch, tm, (2, 8, 64, 128, 512), ((3, 1), (40, 5), (96, 16), (128, 33)),
        lambda tile: 5 * tile + tile // 2 + 1)
    log(f"phase 2a K9: {cases} cases (tile 2..512, d 3..128, B 1..33, f32/bf16, "
        "+inf and +3e38 pads, an all-pad tile): max abs err 0 against the plain "
        f"version (grid data: every sum exact); {mma} on wgmma")


def phase2_score_tile(torch, tm, sc):
    """The shapes the 128 x 128 score tile makes awkward, K9 and K5 against
    their plain versions, exact: batches one past a block's queries, widths
    that end inside a stage (8, 96, 100, 136; in bf16 the first, second and
    fourth take wgmma and 100 the fp32 patch), tiles of 4 rows and of 8 and
    16 chunks, k = 128 at 128 queries, a tile that is no power of two."""
    from pqvector_tpu_torch.kernels.score_tile import pick_backend

    cases, mma = tile_min_cases(
        torch, tm, (2, 4, 16, 128, 1024, 2048),
        ((8, 129), (96, 257), (100, 37), (136, 129), (72, 64)),
        lambda tile: 2 * tile + tile // 2 + 1)
    log(f"phase 2a K9, score tile: {cases} cases (tile 2..2048, d 8/72/96/100/136, "
        f"B 37..257): max abs err 0 against the plain version; {mma} on wgmma")
    dev = torch.device(DEVICE)
    cases = mma = 0
    for n, tile, k, d, b in ((5000, 256, 128, 72, 128), (3000, 1024, 10, 96, 129),
                             (3000, 1024, 10, 100, 257), (700, 64, 10, 8, 37),
                             (5, 256, 9, 136, 5), (2000, 192, 7, 40, 13),
                             (9000, 1024, 128, 128, 130), (4000, 512, 1, 3, 1)):
        emb, sq, q = grid_rows(n, d, tile, seed=n + tile + k, nq=b)
        for dt in (torch.float32, torch.bfloat16):
            E = torch.from_numpy(emb).to(dev).to(dt)
            S = torch.from_numpy(sq).to(dev)
            qf = torch.from_numpy(q).to(dev).to(dt)
            g, w = sc.exact_scan(qf, E, S, k, tile), sc.exact_scan_plain(qf, E, S, k, tile)
            torch.cuda.synchronize()
            check(torch.equal(g[1], w[1]) and torch.equal(g[0], w[0]),
                  f"K5 small n={n} tile={tile} k={k} d={d} B={b} {dt}: "
                  f"{int((g[1] != w[1]).sum())} ids differ from plain")
            cases += 1
            mma += pick_backend(dt, d, E.data_ptr(), qf.data_ptr()) == "wgmma"
    log(f"phase 2a K5, score tile: {cases} cases (k 1..128, B 1..257, d 3..136, tile "
        f"64..1024 and 192, n < k, f32/bf16): ids and distances equal to the plain "
        f"version; {mma} on wgmma")


def phase2_small_k1_k2(torch, ka, st):
    """K1 and K2 on the score tile against their plain versions on 1/4-grid
    data (every score exact, many ties), equal bit for bit: for K1 widths
    that end inside a stage, 1 to 4096 centroids, row counts around a block's
    128 and tripled centroids (ties go to the lowest index); for K2 both back
    ends, k = 1 and 128, B = 1 to 4096, n < k, a last tile that is partly
    pad, and the same result whatever the split of the rows."""
    from pqvector_tpu_torch.kernels.score_tile import pick_backend

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(11)
    cases = 0
    for n, d, kc in ((5, 3, 3), (300, 100, 37), (129, 8, 1), (1000, 16, 4096),
                     (64, 72, 130), (257, 128, 128), (1, 5, 2), (1001, 40, 69)):
        base = rng.integers(-8, 9, (-(-kc // 3), d)).astype(np.float32) / 4
        cent = torch.from_numpy(np.concatenate([base, base, base])[:kc]).to(dev)
        x = torch.from_numpy(
            base[rng.integers(0, base.shape[0], n)]
            + rng.integers(-2, 3, (n, d)).astype(np.float32) / 4).to(dev)
        got, want = ka.assign_rows(x, cent), ka.assign_rows_plain(x, cent)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"K1 small n={n} d={d} k={kc}: {int((got != want).sum())} ids differ")
        check(int(got.max()) < base.shape[0], f"K1 small n={n} d={d} k={kc}: a tie did "
              "not go to the lowest index")
        cases += 1
    log(f"phase 2a K1, score tile: {cases} cases (n 1..1001, d 3..128, 1..4096 "
        "centroids, each centroid repeated): ids equal to the plain version")
    cases = mma = 0
    for n, tile, k, d, b in ((5000, 256, 128, 72, 128), (3000, 1024, 10, 96, 65),
                             (3000, 1024, 10, 100, 256), (700, 64, 10, 8, 13),
                             (5, 256, 9, 136, 1), (2000, 192, 7, 40, 64),
                             (9000, 1024, 128, 128, 130), (4000, 512, 1, 3, 1),
                             (1500, 128, 10, 16, 4096)):
        emb, sq, q = grid_rows(n, d, tile, seed=n + tile + k + 1, nq=b)
        for dt in (torch.float32, torch.bfloat16):
            E = torch.from_numpy(emb).to(dev).to(dt)
            S = torch.from_numpy(sq).to(dev)
            qf = torch.from_numpy(q).to(dev).to(dt)
            w = st.stream_exact_scan_plain(qf, E, S, k)
            for units in (None, 1, 3, 1000):
                g = (st.stream_exact_scan(qf, E, S, k, tile) if units is None
                     else st._stream_exact_cuda(qf, E, S, k, units=units))
                torch.cuda.synchronize()
                check(torch.equal(g[1], w[1]) and torch.equal(g[0], w[0]),
                      f"K2 small n={n} k={k} d={d} B={b} {dt} units={units}: "
                      f"{int((g[1] != w[1]).sum())} ids differ from plain")
                cases += 1
            mma += pick_backend(dt, d, E.data_ptr(), qf.data_ptr()) == "wgmma"
    log(f"phase 2a K2, score tile: {cases} cases (k 1..128, B 1..4096, d 3..136, n < k, "
        f"f32/bf16, 4 splits of the rows each): ids and distances equal to the plain "
        f"version; {mma} of {cases // 4} arrays on wgmma")


def phase2_masked_score_tile(torch, st, sc):
    """K4 and K3 on the score tile against their plain versions on 1/4-grid
    data, equal bit for bit on both back ends: k = 128 at 128 queries (no
    room for a probe table on wgmma), B = 129 and 257, widths that end inside
    a stage, n < k, a tile shorter than a chunk, a last tile whose last
    chunks are all pad rows, a tile of 64 chunks (two segments), rows in
    random order (unsorted slots) with 150 and with 300 clusters a tile (a
    table of 5 words, and one too wide for shared memory), one cluster a
    tile; K3 over three splits of the active tiles. The kernels' counters of
    scored tiles and chunks must equal ``scored_chunks``' wherever a probe
    table is held. -> cases."""
    from pqvector_tpu_torch.kernels.score_tile import CHUNK_ROWS

    dev = torch.device(DEVICE)
    cases = mma = tableless = 0
    # (n, tile, k, d, B, clusters, shuffle)
    for n, tile, k, d, b, kc, shuffle in (
            (5000, 256, 128, 72, 128, 20, False), (3000, 1024, 10, 96, 129, 20, False),
            (3000, 1024, 10, 100, 257, 7, False), (700, 64, 10, 8, 37, 20, False),
            (5, 256, 9, 136, 5, 3, False), (2100, 1024, 10, 96, 129, 20, False),
            (20000, 8192, 10, 16, 13, 40, False), (9000, 1024, 10, 128, 64, 150, True),
            (9000, 1024, 100, 128, 130, 300, True), (600, 128, 5, 40, 3, 1, False),
            (4000, 512, 1, 3, 1, 9, False)):
        cent_np, emb, sq, lcl, tc, q = grid_layout(n, d, kc, tile, seed=n + k + d, nq=b,
                                                   shuffle=shuffle)
        kc_pad = -(-(kc + 1) // 128) * 128
        for dt in (torch.float32, torch.bfloat16):
            E = torch.from_numpy(emb).to(dev).to(dt)
            S = torch.from_numpy(sq).to(dev)
            L = torch.from_numpy(lcl).to(dev)
            TC = torch.from_numpy(tc).to(dev)
            C = torch.from_numpy(cent_np).to(dev)
            Q = torch.from_numpy(q).to(dev)
            qf = Q.to(dt)
            mask = st._probe_mask(Q, C, (C * C).sum(1), min(3, kc), min(20, kc), kc_pad)
            sched = st._tile_schedule(mask, TC)
            lmask = mask[:, TC.long()].permute(1, 0, 2).contiguous()
            backend, queries, words, _ = sc.masked_geometry("K4", qf, E, k, tc.shape[1])
            want_chunks = sc.scored_chunks(lmask > 0.5, L, tile, queries)
            if not words:  # whole tiles
                want_chunks = want_chunks.any(2, keepdim=True).expand(
                    -1, -1, -(-tile // CHUNK_ROWS))
            want_stats = [int(want_chunks.any(2).sum()), int(want_chunks.sum())]
            stats = torch.zeros(2, dtype=torch.int32, device=dev)
            args = (qf, E, S, L, lmask, k, tile)
            g, w = sc.masked_local_scan(*args, stats=stats), sc.masked_local_scan_plain(*args)
            torch.cuda.synchronize()
            what = f"small n={n} tile={tile} k={k} d={d} B={b} kc={kc} {dt}"
            check(torch.equal(g[1], w[1]) and torch.equal(g[0], w[0]),
                  f"K4 {what}: {int((g[1] != w[1]).sum())} ids differ from plain")
            check(stats.tolist() == want_stats,
                  f"K4 {what}: scored {stats.tolist()} tiles and chunks, the rule says "
                  f"{want_stats}")
            args = (qf, E, S, L, TC, mask, sched, k, tile)
            w = st.stream_masked_scan_plain(*args)
            check(torch.equal(w[1], sc._final_merge(*g, k)[1]),
                  f"K3 {what}: the plain versions of K3 and K4 disagree")
            for units in (None, 1, 3):
                stats.zero_()
                g = st._stream_masked_cuda(*args, units=units, stats=stats)
                torch.cuda.synchronize()
                check(torch.equal(g[1], w[1]) and torch.equal(g[0], w[0]),
                      f"K3 {what} units={units}: {int((g[1] != w[1]).sum())} ids differ "
                      "from plain")
                if words:
                    check(stats.tolist() == want_stats,
                          f"K3 {what} units={units}: scored {stats.tolist()}, the rule "
                          f"says {want_stats}")
            cases += 1
            mma += backend == "wgmma"
            tableless += not words
    log(f"phase 2a K4/K3, score tile: {cases} cases (k 1..128, B 1..257, d 3..136, tile "
        f"64..8192, n < k, all-pad chunks, unsorted slots, 1..300 clusters a tile, "
        f"f32/bf16, K3 over 3 splits each): ids and distances equal to the plain "
        f"versions, scored tiles and chunks equal to the skip rule's; {mma} on wgmma, "
        f"{tableless} without a probe table in shared memory")
    return cases


def phase2_small_gather(torch, cp):
    """K10 and K11 against the plain gather at small awkward shapes: bit-equal."""
    dev = torch.device(DEVICE)
    cases = dma = 0
    rng = np.random.default_rng(5)
    for ctile, d in ((512, 96), (128, 3), (4, 96), (2, 3), (64, 128), (1, 5)):
        nt = 37
        for dt in (torch.float32, torch.bfloat16):
            E = torch.from_numpy(rng.standard_normal((nt * ctile, d)).astype(np.float32))
            E = E.to(dev).to(dt)
            S = torch.from_numpy(rng.standard_normal(nt * ctile).astype(np.float32)).to(dev)
            sels = (
                np.array([nt - 1]),  # cap = 1
                np.arange(nt),  # cap = nt
                rng.permutation(nt)[:11],  # out of order
                np.array([3, 3, 0, 36, 3, 0]),  # repeats
            )
            for sel_np in sels:
                sel = torch.from_numpy(sel_np.astype(np.int32)).to(dev)
                want = cp.tile_gather_plain(E, S, sel, ctile)
                before = _BUILD.LAUNCHES["K11"]
                for name, fn in (("K10", cp.tile_gather), ("K11", cp.tile_gather_dma)):
                    got = fn(E, S, sel, ctile)
                    torch.cuda.synchronize()
                    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                          f"{name} small ctile={ctile} d={d} {dt} cap={sel.numel()}: "
                          "differs from plain")
                    cases += 1
                took = _BUILD.LAUNCHES["K11"] - before
                check(took == int(cp.dma_eligible(E, S, ctile)),
                      f"K11 small ctile={ctile} d={d}: launch rule broken")
                dma += took
    log(f"phase 2a K10/K11: {cases} cases (cap 1 and nt, repeats, out of order, "
        f"d 3..128, ctile 1..512, f32/bf16): bit-equal; {dma} went through K11's "
        "bulk copies, the rest (tiles of no multiple of 16 bytes) through K10")


def tile_min_envelope(q, emb_sq, d):
    """The certificate's own slack: max(d, 128) 2^-21 (|q|^2 + max |x|^2)."""
    fin = emb_sq[emb_sq < 1e38]  # neither +inf nor the +3e38 sentinel
    return float(max(d, 128) * 2.0**-21 * ((q * q).sum(1).max() + fin.max()))


def phase2b_slice3(torch, tm, cp, compact_select, s32, s16, q, results):
    """K9 on the 1M x 128 f32 and bf16 arrays and K10/K11 at ``compact``'s
    shapes, against the plain versions and one library chain, timed."""
    n_pad, d = s32.emb.shape
    b = q.shape[0]
    tile = 128
    for name, s, kind in (("f32", s32, "fp32"), ("bf16", s16, "bf16")):
        args = (q, s.emb, s.emb_sq, tile)
        got, want = tm.tile_min(*args), tm.tile_min_plain(*args)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        check(torch.equal(fin, torch.isfinite(got)), f"K9 {name}: pad tiles differ")
        err = float((got - want)[fin].abs().max())
        tol = tile_min_envelope(q, s.emb_sq, d)
        check(err <= tol, f"K9 {name}: max err {err} over the envelope {tol}")
        q2 = (-2.0 * q).to(s.emb.dtype)
        e3 = s.emb.view(n_pad // tile, tile, d)
        sq3 = s.emb_sq.view(1, n_pad // tile, tile)

        def library(q2=q2, e3=e3, sq3=sq3):
            return (torch.einsum("bd,gtd->bgt", q2, e3) + sq3).amin(dim=2)

        res = {
            "max_abs_err": err,
            "ms": time_ms(lambda: tm.tile_min(*args)),
            "plain_ms": time_ms(lambda: tm.tile_min_plain(*args)),
            "library_ms": time_ms(library),
        }
        res.update(bound_of(nbytes_of(q, s.emb, s.emb_sq) + b * (n_pad // tile) * 4,
                            2.0 * b * n_pad * d, kind))
        log(f"phase 2b K9 {name} 1M x {d}, B={b}, tile={tile}: max err {err:.3g} "
            f"(envelope {tol:.3g}); kernel {res['ms']:.3f} ms, plain "
            f"{res['plain_ms']:.3f} ms, einsum + amin {res['library_ms']:.3f} ms, "
            f"bound {res['bound_ms']:.3f} ms ({res['bound_by']})")
        if name == "f32":
            results["K9"] = res
        else:
            results["K9"].update({f"bf16_{key}": v for key, v in res.items()})

    nprobe = 8
    ctile, cap, _ = s16._compact_params(b, nprobe, K)
    tlo, thi, span = s16._compact_tile_ranges(ctile)
    sel = compact_select(q, s16.centroids, s16.c_sq, s16.row_cluster, nprobe,
                         s16._compact_probe_bucket(nprobe), ctile, cap, tlo, thi, span,
                         int(s16.emb.shape[0]))
    gather_check(torch, cp, s16.emb, s16.emb_sq, sel, ctile, results,
                 f"phase 2b 1M x {d} bf16, nprobe={nprobe}")


def gather_check(torch, cp, emb, emb_sq, sel, ctile, results, what):
    """K10 and K11 on one selection: bit-equal to the plain version and to
    each other, timed beside ``index_select``."""
    want = cp.tile_gather_plain(emb, emb_sq, sel, ctile)
    check(cp.dma_eligible(emb, emb_sq, ctile), f"{what}: K11 does not take this shape")
    nt = emb.shape[0] // ctile
    e3, s3, idx = emb.view(nt, -1), emb_sq.view(nt, ctile), sel.long()

    def library():
        return e3.index_select(0, idx), s3.index_select(0, idx)

    moved = 2.0 * (nbytes_of(want[0], want[1])) + sel.numel() * 4
    for name, fn in (("K10", cp.tile_gather), ("K11", cp.tile_gather_dma)):
        before = _BUILD.LAUNCHES[name]
        got = fn(emb, emb_sq, sel, ctile)
        torch.cuda.synchronize()
        check(_BUILD.LAUNCHES[name] == before + 1, f"{what}: {name} was not launched")
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{what}: {name} differs from the plain gather")
        res = {
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: fn(emb, emb_sq, sel, ctile)),
            "plain_ms": time_ms(lambda: cp.tile_gather_plain(emb, emb_sq, sel, ctile)),
            "library_ms": time_ms(library),
        }
        res.update(bound_of(moved, 0.0, "fp32"))
        res["path_launches"] = 1  # the checked call above; the timed ones do not count
        results[name] = res
        log(f"{what} {name}: cap={sel.numel()} of {nt} tiles of {ctile} rows, "
            f"{moved / 2e6:.1f} MB copied, bit-equal; kernel {res['ms']:.3f} ms "
            f"({moved / res['ms'] / 1e9:.2f} TB/s read + write), plain "
            f"{res['plain_ms']:.3f} ms, index_select {res['library_ms']:.3f} ms, "
            f"bound {res['bound_ms']:.3f} ms")
    # Whether K10 and K11 really lose to index_select: the three in turns.
    rounds = interleaved_ms((lambda: cp.tile_gather(emb, emb_sq, sel, ctile),
                             lambda: cp.tile_gather_dma(emb, emb_sq, sel, ctile), library))
    for i, name in enumerate(("K10", "K11")):
        ratio = rounds[:, i] / rounds[:, 2]
        results[name]["vs_index_select"] = {
            "median": float(np.median(ratio)), "min": float(ratio.min()),
            "max": float(ratio.max())}
    log(f"{what} K10, K11 and index_select in turns, 10 rounds of 5 calls: medians "
        f"{np.median(rounds, axis=0).round(4).tolist()} ms; K10 / index_select median "
        f"{results['K10']['vs_index_select']['median']:.3f} "
        f"({results['K10']['vs_index_select']['min']:.3f}-"
        f"{results['K10']['vs_index_select']['max']:.3f}), K11 / index_select median "
        f"{results['K11']['vs_index_select']['median']:.3f} "
        f"({results['K11']['vs_index_select']['min']:.3f}-"
        f"{results['K11']['vs_index_select']['max']:.3f})")


def interleaved_ms(fns, rounds=10, calls=5):
    """ms per call of each of ``fns``, timed in turns: each round times
    ``calls`` back-to-back calls of every function with CUDA events.
    -> [rounds, len(fns)]."""
    import torch

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    out = np.zeros((rounds, len(fns)))
    for r in range(rounds):
        for i, fn in enumerate(fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize()
            out[r, i] = start.elapsed_time(end) / calls
    return out


def masked_library_ms(torch, qf, emb, sq, row_cluster, mask, k, reps=10):
    """The chain a user would write for a masked top-k: one product, the probe
    mask gathered through each row's cluster, ``topk``. It is what K3, K4
    (before their merge) and K6 compute; the port calls it nowhere."""
    rc = row_cluster.long()

    def chain():
        score = sq[None, :] - 2.0 * (qf @ emb.T).float()
        score = torch.where(mask[:, rc] > 0.5, score, 3.0e38)
        return torch.topk(score, k, dim=1, largest=False)

    return time_ms(chain, reps=reps)


def probed_work(torch, mask, row_cluster, d, esize):
    """What a masked scan of this batch needs: -> (bytes of the rows some
    query probes, each read once with its norm and slot; multiply-adds x 2
    over the (query, row) pairs the queries probe)."""
    sizes = torch.bincount(row_cluster.long(), minlength=mask.shape[1])[: mask.shape[1]]
    rows = float(sizes[mask.amax(dim=0) > 0.5].sum())
    pairs = float((mask.double() @ sizes.double()).sum())
    return rows * (d * esize + 8), 2.0 * pairs * d


def masked_timed(torch, sc, st, qf, emb, sq, lcl, tc, mask, sched, row_cluster, k, tile,
                 kind, stored, what):
    """K3 and K4 on one array at one batch: each held to its plain version
    (``stored``: the float64 (queries, rows, norms) that judge near-ties),
    K3's ids held to K4's merge, the kernels' counters of scored tiles and
    chunks held to the skip rule's, and both timed beside the plain versions
    and the product + gathered mask + ``topk`` chain, with their bounds.
    With ``stored`` None (the 10M rung, where float64 copies and a [B, n]
    score matrix do not fit the time) both are held on the card to K3's plain
    version over the active tiles, distances within 1e-5 (|q|^2 + max
    |x|^2), and only the kernels are timed.
    -> {"K3": {...}, "K4": {...}, "work": {...}}."""
    deep = stored is None
    reps = 5 if deep else 10
    lmask = mask[:, tc.long()].permute(1, 0, 2).contiguous()
    nt, b = lmask.shape[0], qf.shape[0]
    backend, queries, words, _ = sc.masked_geometry("K4", qf, emb, k, tc.shape[1])
    chunks = sc.scored_chunks(lmask > 0.5, lcl, tile, queries)
    work = {"backend": backend, "table_words": words, "active_tiles": int(sched[0]),
            "tiles": nt, "block_tiles": chunks.shape[0] * chunks.shape[1],
            "block_tiles_scored": int(chunks.any(2).sum()),
            "block_chunks": chunks.numel(), "block_chunks_scored": int(chunks.sum())}
    del chunks
    a3 = (qf, emb, sq, lcl, tc, mask, sched, k, tile)
    a4 = (qf, emb, sq, lcl, lmask, k, tile)
    stats = torch.zeros(2, dtype=torch.int32, device=emb.device)
    g4 = sc.masked_local_scan(*a4, stats=stats)
    m4 = sc._final_merge(*g4, k)
    del g4
    got4 = stats.tolist()
    stats.zero_()
    g3 = st.stream_masked_scan(*a3, stats=stats)
    torch.cuda.synchronize()
    if words:
        want = [work["block_tiles_scored"], work["block_chunks_scored"]]
        check(got4 == want and stats.tolist() == want,
              f"{what}: K4 scored {got4}, K3 {stats.tolist()} tiles and chunks; the skip "
              f"rule says {want}")
    check(torch.equal(g3[1], m4[1]), f"{what}: K3's ids differ from K4's merged ids")
    w3 = st.stream_masked_scan_plain(*a3)
    out = {"work": work}
    for name, got, wantp in (("K3", g3, w3), ("K4", m4, w3)):
        if name == "K4" and not deep:
            wantp = sc._final_merge(*sc.masked_local_scan_plain(*a4), k)
        if not deep:
            err, swaps = compare_topk(got, wantp, *stored)
        else:
            fin = sq[sq < 1e38]
            tol = 1e-5 * float((qf.float() ** 2).sum(1).max() + fin.max())
            check(torch.equal(got[1] >= 0, wantp[1] >= 0), f"{what} {name}: empty slots differ")
            real = wantp[1] >= 0
            err = float((got[0] - wantp[0])[real].abs().max()) if bool(real.any()) else 0.0
            check(err <= tol, f"{what} {name}: distances differ from plain by {err}")
            swaps = int((got[1] != wantp[1]).sum())
        out[name] = {"max_abs_err": err, "swaps": swaps}
    del w3, wantp, m4, g3
    out["K3"]["ms"] = time_ms(lambda: st.stream_masked_scan(*a3), reps=reps)
    out["K4"]["ms"] = time_ms(lambda: sc.masked_local_scan(*a4), reps=reps)
    lib = None
    if not deep:
        out["K3"]["plain_ms"] = time_ms(lambda: st.stream_masked_scan_plain(*a3))
        out["K4"]["plain_ms"] = time_ms(lambda: sc.masked_local_scan_plain(*a4))
        lib = masked_library_ms(torch, qf, emb, sq, row_cluster, mask, k, reps=5)
    row_bytes, ops = probed_work(torch, mask, row_cluster, emb.shape[1], emb.element_size())
    out["K3"].update(bound_of(row_bytes + nbytes_of(qf, mask, tc, sched) + b * k * 8, ops, kind),
                     library_ms=lib)
    out["K4"].update(bound_of(row_bytes + nbytes_of(qf, lmask) + nt * b * k * 8, ops, kind),
                     library_ms=lib)

    def ms(value):
        return "not timed" if value is None else f"{value:.3f} ms"

    log(f"{what}: {work['active_tiles']} of {nt} tiles active; blocks of {queries} queries on "
        f"{backend} score {work['block_tiles_scored']} of {work['block_tiles']} (block, tile) "
        f"pairs and {work['block_chunks_scored']} of {work['block_chunks']} (block, chunk) "
        f"pairs. K3: {out['K3']['swaps']} near-tie swaps, max err {out['K3']['max_abs_err']:.3g}; "
        f"kernel {out['K3']['ms']:.3f} ms, plain {ms(out['K3'].get('plain_ms'))}, bound "
        f"{out['K3']['bound_ms']:.3f} ms ({out['K3']['bound_by']}). K4: {out['K4']['swaps']} "
        f"near-tie swaps after the merge, max err {out['K4']['max_abs_err']:.3g}; kernel "
        f"{out['K4']['ms']:.3f} ms, plain {ms(out['K4'].get('plain_ms'))}, bound "
        f"{out['K4']['bound_ms']:.3f} ms ({out['K4']['bound_by']}). mm + gathered mask + topk "
        f"{ms(lib)}; K3's ids equal K4's")
    return out


def deep_masked(torch, sc, st, s, q, nprobe=4):
    """K4 and K3 at the 10M x 96 rung's shapes (tiles of 1024 rows of the
    sorted searcher, 4096 clusters), on its f32 copy and its bf16 storage."""
    tile = s._scan_tile()
    lcl, tc, cmax = s._tile_cluster_table(tile)
    kc_pad = -(-(DEEP_CLUSTERS + 1) // 128) * 128
    mask = st._probe_mask(q, s.centroids, s.c_sq, nprobe, s._max_probe_bucket(nprobe), kc_pad)
    sched = st._tile_schedule(mask, tc)
    sq = s._pallas_emb_sq()
    out = {"work": {}}
    for name, emb, kind in (("f32", s._ref(), "fp32"), ("bf16", s.emb, "bf16")):
        res = masked_timed(torch, sc, st, q.to(emb.dtype), emb, sq, lcl, tc, mask, sched,
                           s.row_cluster, K, tile, kind, None,
                           f"phase 7b K3/K4 {name} 10M x {DEEP_DIM}, nprobe={nprobe}, "
                           f"cmax={cmax}")
        out["work"][f"10M x {DEEP_DIM} {name}"] = res.pop("work")
        out[name] = res
    return out


def k2_timed(torch, st, qf, emb, sq, k, tile, kind, stored):
    """K2 at one of the main path's shapes: held to its plain version (ids
    equal except near-ties within the f32 tolerance; ``stored`` is the
    float64 (queries, rows, norms) that judges them), then timed beside the
    plain version and the ``mm`` + ``topk`` chain, with the bound."""
    args = (qf, emb, sq, k)
    err, swaps = compare_topk(st.stream_exact_scan(*args, tile),
                              st.stream_exact_scan_plain(*args), *stored)
    res = {
        "max_abs_err": err,
        "swaps": swaps,
        "ms": time_ms(lambda: st.stream_exact_scan(*args, tile)),
        "plain_ms": time_ms(lambda: st.stream_exact_scan_plain(*args), reps=3),
        "library_ms": time_ms(lambda: torch.topk(
            sq[None, :] - 2.0 * (qf @ emb.T).float(), k, dim=1, largest=False)),
    }
    res.update(bound_of(nbytes_of(qf, emb, sq) + qf.shape[0] * k * 8,
                        2.0 * qf.shape[0] * emb.shape[0] * emb.shape[1], kind))
    log(f"phase 2b K2 {emb.dtype} 1M x {emb.shape[1]}, B={qf.shape[0]}, k={k}: {swaps} "
        f"near-tie swaps, max err {err:.3g}; kernel {res['ms']:.3f} ms, plain "
        f"{res['plain_ms']:.3f} ms, mm + topk {res['library_ms']:.3f} ms, bound "
        f"{res['bound_ms']:.3f} ms ({res['bound_by']})")
    return res


def assign_near_ties(torch, x, c, got, want, what):
    """Rows where K1 and its plain version differ must be near-ties: the two
    centroids' float64 scores within 1e-5 (|x|^2 + max |c|^2). -> (rows that
    differ, the largest score gap among them)."""
    rows = torch.nonzero(got != want).flatten()
    if rows.numel() == 0:
        return 0, 0.0
    xr, c64 = x[rows].double(), c.double()
    cn = (c64 * c64).sum(1)

    def score(ids):
        return cn[ids.long()] - 2.0 * (xr * c64[ids.long()]).sum(1)

    gap = (score(got[rows]) - score(want[rows])).abs()
    tol = 1e-5 * ((xr * xr).sum(1) + cn.max())
    check(bool((gap <= tol).all()), f"{what}: a differing row is no tie")
    return int(rows.numel()), float(gap.max())


def deep_assign(torch, ka, s):
    """K1 at the 10M x 96 rung's shapes (the sorted searcher's f32 copy
    against its 4096 centroids): held to the plain version, timed. The
    ``mm`` + ``argmin`` chain would need a 164 GB score matrix here, so the
    blocked plain version is the only other form."""
    x, c = s._ref(), s.centroids
    got, want = ka.assign_rows(x, c), ka.assign_rows_plain(x, c)
    torch.cuda.synchronize()
    differ, gap = assign_near_ties(torch, x, c, got, want, "deep K1")
    del got, want
    res = {"differ": differ, "max_abs_err": gap,
           "ms": time_ms(lambda: ka.assign_rows(x, c), reps=3),
           "plain_ms": time_ms(lambda: ka.assign_rows_plain(x, c), reps=1)}
    res.update(bound_of(nbytes_of(x, c) + x.shape[0] * 4,
                        2.0 * x.shape[0] * c.shape[0] * x.shape[1], "fp32"))
    log(f"phase 7b K1 {x.shape[0]} x {x.shape[1]}, {c.shape[0]} centroids: {differ} "
        f"near-tie rows differ from plain; kernel {res['ms']:.3f} ms, plain (blocks of "
        f"8192 rows) {res['plain_ms']:.3f} ms, bound {res['bound_ms']:.3f} ms "
        f"({res['bound_by']})")
    return res


def deep_score_tile(torch, tm, sc, st, s, q):
    """K9 and K5 at the 10M x 96 rung's shapes, on the sorted searcher's f32
    copy and on its bf16 storage: K9 against its plain version within the
    certificate's envelope, K5's merged result against K2's on the same array
    (equal, or tied within the f32 tolerance), both timed."""
    out = {}
    n_pad, d = s.emb.shape
    b = q.shape[0]
    tile9, tile5 = s._cert_tile_checked(K), s._scan_tile()
    sq5 = s._pallas_emb_sq()
    tol5 = 1e-5 * float((q * q).sum(1).max() + sq5[sq5 < 1e38].max())
    for name, emb, kind in (("f32", s._ref(), "fp32"), ("bf16", s.emb, "bf16")):
        args = (q, emb, s.emb_sq, tile9)
        got, want = tm.tile_min(*args), tm.tile_min_plain(*args)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        check(torch.equal(fin, torch.isfinite(got)), f"deep K9 {name}: pad tiles differ")
        err9 = float((got - want)[fin].abs().max())
        check(err9 <= tile_min_envelope(q, s.emb_sq, d), f"deep K9 {name}: max err {err9}")
        del got, want
        q2 = (-2.0 * q).to(emb.dtype)
        e3, sq3 = emb.view(n_pad // tile9, tile9, d), s.emb_sq.view(1, -1, tile9)
        res = {"K9_max_abs_err": err9,
               "K9_ms": time_ms(lambda: tm.tile_min(*args), reps=5),
               "K9_library_ms": time_ms(
                   lambda: (torch.einsum("bd,gtd->bgt", q2, e3) + sq3).amin(dim=2), reps=3)}
        res["K9_bound_ms"] = bound_of(nbytes_of(q, emb, s.emb_sq) + b * (n_pad // tile9) * 4,
                                      2.0 * b * n_pad * d, kind)["bound_ms"]
        qf = q.to(emb.dtype)
        g = sc._final_merge(*sc.exact_scan(qf, emb, sq5, K, tile5), K)
        w = st.stream_exact_scan(qf, emb, sq5, K, tile5)
        torch.cuda.synchronize()
        err5 = float((g[0] - w[0]).abs().max())
        check(err5 <= tol5, f"deep K5 {name}: distances differ from K2's by {err5}")
        res.update({"K5_max_abs_err_vs_K2": err5, "K5_ids_differ": int((g[1] != w[1]).sum()),
                    "K5_ms": time_ms(lambda: sc.exact_scan(qf, emb, sq5, K, tile5), reps=5),
                    "K2_ms": time_ms(lambda: st.stream_exact_scan(qf, emb, sq5, K, tile5),
                                     reps=3)})
        res["K5_bound_ms"] = bound_of(
            nbytes_of(qf, emb, sq5) + (n_pad // tile5) * b * K * 8, 2.0 * b * n_pad * d,
            kind)["bound_ms"]
        out[name] = res
        log(f"phase 7b K9 {name} 10M x {d}, B={b}, tile={tile9}: max err {err9:.3g}; kernel "
            f"{res['K9_ms']:.3f} ms, einsum + amin {res['K9_library_ms']:.3f} ms, bound "
            f"{res['K9_bound_ms']:.3f} ms. K5 {name} tile={tile5}, k={K}: "
            f"{res['K5_ids_differ']} ids differ from K2's (near-ties), max err {err5:.3g}; "
            f"kernel {res['K5_ms']:.3f} ms, K2 {res['K2_ms']:.3f} ms, bound "
            f"{res['K5_bound_ms']:.3f} ms")
    return out


def ids_equal_or_tied(got, want, what):
    """Two exact results: distances equal to 1e-5 relative, and ids equal
    except where two rows tie at that distance. -> swapped ids."""
    gd, wd = got[0].double().cpu().numpy(), want[0].double().cpu().numpy()
    gi, wi = got[1].cpu().numpy(), want[1].cpu().numpy()
    check(np.allclose(gd, wd, rtol=1e-5, atol=1e-6), f"{what}: distances differ")
    rows, cols = np.nonzero(gi != wi)
    for r, c in zip(rows, cols):
        check(gi[r, c] in wi[r] or np.isclose(gd[r, c], wd[r, c], rtol=1e-6),
              f"{what}: query {r} slot {c}: ids {gi[r, c]} vs {wi[r, c]} are no tie")
    return int(rows.size)


def profile_modes(torch, calls, reps=10):
    """torch.profiler over ``reps`` batches of each call -> {name: {wall_ms,
    device_ms, idle_share, top}}: device_ms sums the kernels' own time per
    batch, idle = 1 - device / wall, top the three largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in calls:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / reps * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        kernels = [(e.key, getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0)) / 1e3 / reps)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels.sort(key=lambda kv: -kv[1])
        dev_ms = sum(ms for _, ms in kernels)
        out[name] = {"wall_ms": wall, "device_ms": dev_ms,
                     "idle_share": 1.0 - dev_ms / wall if dev_ms else None,
                     "top": [(key[:60], round(ms, 3)) for key, ms in kernels[:3]]}
        log(f"profile {name}: wall {wall:.3f} ms/batch, kernels {dev_ms:.3f} ms, idle "
            f"{out[name]['idle_share']}, top {out[name]['top']}")
    return out


def phase7(torch, ds, truth_s, sorted16, q, truth, nprobe, card):
    """Slice 3 on the 1M file: ``cert`` on the f32 truth searcher and on the
    sorted bf16 searcher (f32 copy), the forced fallback, and the ``compact``,
    ``scan``, ``approx`` and ``masked`` searches, through the loops."""
    out = {}
    _BUILD.reset_launches()
    runs = ((truth_s, "highest", "f32"), (sorted16, "highest", "bf16+f32 copy"),
            (sorted16, "storage", "bf16+f32 copy"))
    for s, p1, what in runs:
        s.cert_pass1 = p1
        frac, margins = s.cert_probe(q, K)
        k9, k2 = _BUILD.LAUNCHES["K9"], _BUILD.LAUNCHES["K2"]
        got = s.exact(q, K, "cert")
        check(_BUILD.LAUNCHES["K9"] == k9 + 1, "exact(cert) did not take K9")
        fell = _BUILD.LAUNCHES["K2"] - k2
        check(fell == int(frac < 1.0), f"cert {what} {p1}: certified {frac} but "
              f"{fell} fallback runs")
        swaps = ids_equal_or_tied(got, truth, f"cert {what} pass1={p1}")
        also = s.search(q, K, 1, "cert")
        check(torch.equal(also[1], got[1]), "search(cert) and exact(cert) differ")
        ms = time_ms(lambda: s.exact_loop(q, K, reps=10, mode="cert"), reps=3) / 10
        out[f"cert_{what.split('+')[0]}_{p1}"] = {
            "certified": frac, "fallback": bool(fell), "swaps": swaps, "ms": ms,
            "qps": BATCH / (ms / 1e3), "min_margin": float(np.nanmin(margins))}
        log(f"phase 7 exact(cert) {what}, pass1={p1}, tile={s._cert_tile_checked(K)}: "
            f"certified {frac:.4f} (least margin {np.nanmin(margins):.4g}), "
            f"{'K2 fallback ran' if fell else 'no fallback'}; equal to the K2 truth "
            f"({swaps} tied ids swapped); {ms:.3f} ms/batch, {BATCH / (ms / 1e3):.0f} QPS")
        s.cert_pass1 = "highest"
    truth_s.cert_fetch_tiles = 1
    frac, _ = truth_s.cert_probe(q, K)
    k2 = _BUILD.LAUNCHES["K2"]
    got = truth_s.exact(q, K, "cert")
    check(_BUILD.LAUNCHES["K2"] == k2 + 1, "cert with one fetched tile did not fall back")
    swaps = ids_equal_or_tied(got, truth, "cert forced fallback")
    truth_s.cert_fetch_tiles = 0
    out["cert_forced_fallback"] = {"certified": frac, "swaps": swaps}
    log(f"phase 7 exact(cert) with cert_fetch_tiles=1: certified {frac:.4f}, fell back "
        "to K2, equal to the truth")
    ms2 = time_ms(lambda: truth_s.exact_loop(q, K, reps=10, mode="stream"), reps=3) / 10
    out["exact_stream_ms"] = ms2
    log(f"phase 7 exact(stream) K2, f32, same loop: {ms2:.3f} ms/batch")

    truth_np = truth[1].cpu().numpy()
    for s, what in ((truth_s, "f32"), (sorted16, "bf16")):
        ref = s.search(q, K, nprobe, "pallas")
        r_ref = ds.recall_at_k(truth_np, ref[1].cpu().numpy())
        for mode in ("compact", "scan", "approx", "masked"):
            k10 = _BUILD.LAUNCHES["K10"]
            got = s.search(q, K, nprobe, mode)
            if mode == "compact":
                check(_BUILD.LAUNCHES["K10"] == k10 + 1, "search(compact) did not take K10")
            r = ds.recall_at_k(truth_np, got[1].cpu().numpy())
            same = int((got[1] == ref[1]).sum())
            reps = 3 if mode == "masked" else 10
            ms = time_ms(lambda: s.search_loop(q, K, nprobe, reps=reps, mode=mode),
                         reps=2) / reps
            out[f"{mode}_{what}"] = {"recall_at_10": r, "ms": ms,
                                     "qps": BATCH / (ms / 1e3)}
            log(f"phase 7 search({mode}) {what} nprobe={nprobe}: recall@{K} {r:.4f} "
                f"(pallas {r_ref:.4f}), {same} of {got[1].numel()} ids equal to "
                f"pallas's; {ms:.3f} ms/batch, {BATCH / (ms / 1e3):.0f} QPS")
            if mode == "scan":
                check(r >= RECALL_TARGET, f"scan recall {r:.4f} < {RECALL_TARGET}")
            elif mode == "masked" and what == "f32":
                ids_equal_or_tied(got, ref, "masked vs pallas, f32")
            else:
                check(r >= r_ref - 0.002, f"{mode} {what} recall {r:.4f} under "
                      f"pallas's {r_ref:.4f}")
    ctile, cap, chunk = sorted16._compact_params(BATCH, nprobe, K)
    out["compact_params"] = {"ctile": ctile, "cap": cap, "chunk": chunk,
                             "coverage": sorted16.compact_coverage(BATCH, nprobe, K)}
    log(f"phase 7 compact at B={BATCH} x nprobe={nprobe}: ctile={ctile}, cap={cap}, "
        f"coverage {out['compact_params']['coverage']:.3f}")
    out["launches"] = dict(_BUILD.LAUNCHES)
    for name in ("K2", "K9", "K10"):
        check(out["launches"][name] > 0, f"{name} was not launched on slice 3's path")
    log(f"phase 7 launches on slice 3's path: {out['launches']}")
    out["profile"] = profile_modes(torch, (
        ("exact(cert) f32", lambda: truth_s.exact(q, K, "cert")),
        ("exact(auto) f32", lambda: truth_s.exact(q, K)),
        ("search(compact) bf16", lambda: sorted16.search(q, K, nprobe, "compact")),
        ("search(auto) bf16", lambda: sorted16.search(q, K, nprobe, "auto")),
        ("search(stream) bf16", lambda: sorted16.search(q, K, nprobe, "stream")),
    ))
    log(f"phase 7 on {card}")
    return out


def phase7b(torch, ds, cp, compact_select, s, q256, truth):
    """Slice 3 on the 10M x 96 rung: ``compact`` at nprobe 4 on the sorted
    bf16 searcher (K10 and K11 on its selection), and ``cert`` against the
    K2 truth."""
    out = {}
    truth_ids = truth[1].cpu().numpy()
    nprobe = 4
    ctile, cap, chunk = s._compact_params(256, nprobe, K)
    nt = s.emb.shape[0] // ctile
    k10 = _BUILD.LAUNCHES["K10"]
    _, ids = s.search(q256, K, nprobe, "compact")
    check(_BUILD.LAUNCHES["K10"] == k10 + 1, "deep search(compact) did not take K10")
    r = ds.recall_at_k(truth_ids, ids.cpu().numpy())
    ms = time_ms(lambda: s.search_loop(q256, K, nprobe, reps=5, mode="compact"),
                 reps=2) / 5
    out["compact"] = {"nprobe": nprobe, "ctile": ctile, "cap": cap, "chunk": chunk,
                      "coverage": cap / nt, "recall_at_10": r, "ms": ms,
                      "qps": 256 / (ms / 1e3)}
    log(f"phase 7b compact nprobe={nprobe}: ctile={ctile}, cap={cap} of {nt} tiles "
        f"(coverage {cap / nt:.3f}), recall@{K} {r:.4f}, {ms:.2f} ms/batch, "
        f"{256 / (ms / 1e3):.0f} QPS")
    tlo, thi, span = s._compact_tile_ranges(ctile)
    sel = compact_select(q256, s.centroids, s.c_sq, s.row_cluster, nprobe,
                         s._compact_probe_bucket(nprobe), ctile, cap, tlo, thi, span,
                         int(s.emb.shape[0]))
    deep = {}
    gather_check(torch, cp, s.emb, s.emb_sq, sel, ctile, deep,
                 f"phase 7b 10M x {DEEP_DIM} bf16, nprobe={nprobe}")
    out["gather"] = deep
    for p1 in ("highest", "storage"):
        s.cert_pass1 = p1
        frac, margins = s.cert_probe(q256, K)
        k9, k2 = _BUILD.LAUNCHES["K9"], _BUILD.LAUNCHES["K2"]
        got = s.exact(q256, K, "cert")
        check(_BUILD.LAUNCHES["K9"] == k9 + 1, "deep exact(cert) did not take K9")
        fell = _BUILD.LAUNCHES["K2"] - k2
        diff = ids_equal_or_tied(got, truth, f"deep cert pass1={p1}")
        ms = time_ms(lambda: s.exact(q256, K, "cert"), reps=3)
        out[f"cert_{p1}"] = {"certified": frac, "fallback": bool(fell),
                             "swaps": diff, "ms": ms}
        log(f"phase 7b exact(cert) sorted bf16 + f32 copy, pass1={p1}: certified "
            f"{frac:.4f}, {'K2 fallback ran' if fell else 'no fallback'}; equal to the "
            f"K2 truth ({diff} tied ids swapped); {ms:.2f} ms/batch")
    s.cert_pass1 = "highest"
    return out


# --------------------------------------------------------------------------


FRONT_QUERIES, FRONT_NPROBE, FRONT_FILTER = 64, 8, "WHERE id >= 500000"
#: TopkBuilder reads the file's index and offset index anew on every call
#: (about 2 s a query at 1M rows), so it runs the first few plain queries.
FRONT_TOPK_QUERIES = 8


def write_page_indexed(path, emb_np):
    """The phase-3 rows again, with an offset index and pages of 8 rows
    (4 KB), so the page-exact reader serves a candidate read."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    n, d = emb_np.shape
    vec = pa.ListArray.from_arrays(pa.array(np.arange(n + 1, dtype=np.int32) * d),
                                   pa.array(emb_np.reshape(-1), pa.float32()))
    pq.write_table(pa.table({"id": pa.array(np.arange(n)), "embedding": vec}), path,
                   compression="snappy", use_dictionary=False, write_page_index=True,
                   row_group_size=65536, data_page_size=4096, write_batch_size=8)


def vector_sql(q, where=""):
    lit = ", ".join(repr(float(v)) for v in q)
    where = f"{where} " if where else ""
    return f"SELECT id FROM t {where}ORDER BY array_distance(embedding, [{lit}]) LIMIT {K}"


def topk_node(plan):
    return next((n for n in _walk_plan(plan) if n.name == "VectorTopKExec"), None)


def same_or_tied(got, want, emb_np, q, what):
    """Two top-k id lists from the same probed rows: equal, except that
    rows whose squared distances (f64, from the file's rows) tie with the
    k-th to 1e-5 relative may swap. -> swapped slots."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    check(got.size == want.size, f"{what}: {got.size} ids, want {want.size}")
    if np.array_equal(got, want):
        return 0
    q64 = q.astype(np.float64)
    d2 = lambda ids: ((emb_np[ids].astype(np.float64) - q64) ** 2).sum(1)  # noqa: E731
    dg, dw = d2(got), d2(want)
    check(np.allclose(np.sort(dg), np.sort(dw), rtol=1e-5, atol=1e-6),
          f"{what}: distances differ: {dg} vs {dw}")
    kth = dw.max()
    swapped = np.setxor1d(got, want)
    for i in swapped:
        check(abs(d2(np.array([i]))[0] - kth) <= 1e-5 * kth,
              f"{what}: id {i} is no tie at the k-th distance")
    return int((got != want).sum())


def run_sql(session, sql):
    """-> (ids, ms on the host clock, resident candidates, stage seconds)."""
    from pqvector_tpu_torch.utils.profiling import drain_stages

    drain_stages()
    t0 = time.perf_counter()
    df = session.sql(sql)
    table = df.collect()
    ms = (time.perf_counter() - t0) * 1e3
    stages = {}
    for name, sec in drain_stages():
        stages[name] = stages.get(name, 0.0) + sec
    node = topk_node(df.physical_plan())
    check(node is not None, "the rewrite did not fire: no VectorTopKExec")
    return (table.column("id").to_pylist(), ms,
            node.metrics.value("resident_candidates"), stages, df)


def phase8(torch, pqt, _build, ds, emb_np, queries, truth_np, index_bytes, data_dir, card):
    """The front doors on the card: SQL (host path, resident f32 and bf16
    searchers), TopkBuilder, and the CLI, on a page-indexed copy of the
    phase-3 rows, checked against each other and the K2 truth."""
    from pqvector_tpu_torch.engine import Session, VectorTopKOptions
    from pqvector_tpu_torch.engine import exec as texec
    from pqvector_tpu_torch.io import native
    from pqvector_tpu_torch.io.pages import PageSelectiveReader

    out = {}
    path = os.path.join(data_dir, f"paged_{ROWS}x{DIM}.parquet")
    t0 = time.perf_counter()
    write_page_indexed(path, emb_np)
    out["write_s"] = time.perf_counter() - t0
    check(PageSelectiveReader(path, pqt.EmbeddingColumn("embedding")).supports_page_reads,
          "the phase-8 file has no offset index")
    out["native_decoder"] = native.load() is not None
    check(out["native_decoder"], "phase 8: the native page decoder did not build; the "
          "Python decoder's times are not the port's")
    log(f"phase 8 wrote {os.path.basename(path)} ({os.path.getsize(path) / 1e6:.1f} MB, "
        f"offset index, 8-row pages) in {out['write_s']:.1f} s; native page decoder "
        f"loaded")

    _build.reset_launches()
    t0 = time.perf_counter()
    index = pqt.IndexBuilder(path, "embedding").n_clusters(N_CLUSTERS).build_inplace()
    out["build_s"] = time.perf_counter() - t0
    check(index.to_bytes() == index_bytes, "phase 8 index differs from phase 3's")
    log(f"phase 8 build_inplace IVF-{N_CLUSTERS} (K1) in {out['build_s']:.2f} s: index "
        f"bytes equal phase 3's")

    host = Session(VectorTopKOptions(nprobe=FRONT_NPROBE))
    host.register_parquet("t", path)
    res32 = Session(VectorTopKOptions(nprobe=FRONT_NPROBE))
    res32.register_parquet("t", path)
    res16 = Session(VectorTopKOptions(nprobe=FRONT_NPROBE))
    res16.register_parquet("t", path)
    t0 = time.perf_counter()
    s32 = res32.device_searcher("t")
    s16 = res16.device_searcher("t", dtype=torch.bfloat16)
    out["searchers_s"] = time.perf_counter() - t0
    check(s32.device.type == "cuda" and s16.emb.dtype == torch.bfloat16
          and s16._emb_ref is not None, "resident searchers are not f32 / bf16 + f32 copy")
    explain = host.sql(vector_sql(queries[0])).explain()
    check("VectorTopKExec" in explain, f"explain() shows no VectorTopKExec:\n{explain}")
    log("phase 8 plan: " + " | ".join(line.strip() for line in explain.splitlines()))

    qs = queries[:FRONT_QUERIES]
    ms = {"a_host": [], "b_resident_f32": [], "c_resident_bf16": [], "d_topk_builder": []}
    share = {"b_resident_f32": [0.0, 0.0], "c_resident_bf16": [0.0, 0.0]}
    host_stages: dict[str, float] = {}
    swaps = {"b": 0, "c": 0, "d": 0}
    host_ids = []
    pages = 0
    for where in ("", FRONT_FILTER):
        for i, q in enumerate(qs):
            sql = vector_sql(q, where)
            ids_a, t_a, r_a, st_a, df_a = run_sql(host, sql)
            check(r_a == 0, "the host session took the resident path")
            check(len(ids_a) == K, f"host path returned {len(ids_a)} rows")
            if where:
                check(all(i_ >= 500000 for i_ in ids_a), "the filter was not applied")
            else:
                host_ids.append(ids_a)
            for node in (n for n in _walk_plan(df_a.physical_plan())
                         if n.name == "DataSourceExec"):
                pages += node.metrics.value("pages_read")
            ms["a_host"].append(t_a)
            for name, sec in st_a.items():
                host_stages[name] = host_stages.get(name, 0.0) + sec
            for key, sess in (("b_resident_f32", res32), ("c_resident_bf16", res16)):
                ids_r, t_r, r_r, st_r, _ = run_sql(sess, sql)
                check(r_r > 0, f"{key}: query {i} {where!r} did not take the resident path")
                swaps[key[0]] += same_or_tied(ids_r, ids_a, emb_np, q,
                                              f"phase 8 {key} query {i} {where!r}")
                ms[key].append(t_r)
                share[key][0] += st_r.get("vector_topk.resident.device_search", 0.0)
                share[key][1] += st_r.get("vector_topk.resident.fetch_and_topk", 0.0)
            if not where and i < FRONT_TOPK_QUERIES:
                t0 = time.perf_counter()
                hits = pqt.TopkBuilder(path, q).k(K).nprobe(FRONT_NPROBE).search()
                ms["d_topk_builder"].append((time.perf_counter() - t0) * 1e3)
                swaps["d"] += same_or_tied([h.row_idx for h in hits], ids_a, emb_np, q,
                                           f"phase 8 TopkBuilder query {i}")
    check(pages > 0, "the host path read no candidate pages")
    out["recall_at_10"] = ds.recall_at_k(truth_np[:FRONT_QUERIES], np.asarray(host_ids))
    out["median_ms_per_query"] = {key: float(np.median(v)) for key, v in ms.items()}
    out["resident_device_search_share"] = {
        key: dev_s / (dev_s + fetch_s) for key, (dev_s, fetch_s) in share.items()}
    out["host_stage_ms_per_query"] = {
        name: 1e3 * sec / (2 * FRONT_QUERIES) for name, sec in host_stages.items()}
    out["swaps_vs_host"] = swaps
    out["pages_read_per_query"] = pages / (2 * FRONT_QUERIES)
    log(f"phase 8 {2 * FRONT_QUERIES} SQL queries (plain and {FRONT_FILTER}) on each "
        f"session: resident f32 and bf16 took the resident path on every one and gave "
        f"the host path's ids ({swaps['b']} / {swaps['c']} slots swapped at a tie); "
        f"TopkBuilder gave them on {FRONT_TOPK_QUERIES} ({swaps['d']} swapped); recall@{K} "
        f"against the K2 truth {out['recall_at_10']:.4f} at nprobe={FRONT_NPROBE}")
    log("phase 8 median ms per query: " + ", ".join(
        f"{key} {v:.3f}" for key, v in out["median_ms_per_query"].items())
        + f"; host path {out['pages_read_per_query']:.0f} pages read per query; on {card}")
    log("phase 8 resident share in device_search vs fetch + top-k: " + ", ".join(
        f"{key} {v:.3f}" for key, v in out["resident_device_search_share"].items())
        + "; host stages ms per query: " + json.dumps(out["host_stage_ms_per_query"]))

    # _device_sqdist: a candidate set above the threshold, re-scored on the card.
    q = queries[0]
    sql = vector_sql(q)
    calls = []
    orig = texec._device_sqdist

    def spy(mat, qv, device):
        calls.append((mat.shape[0], str(device)))
        return orig(mat, qv, device)

    texec._device_sqdist = spy
    try:
        picked = {}
        for use_device in (True, False):
            sess = Session(VectorTopKOptions(nprobe=32, use_device=use_device))
            sess.register_parquet("t", path)
            ids_u, t_u, _, _, _ = run_sql(sess, sql)
            ids_u, t_u, _, _, _ = run_sql(sess, sql)  # warm
            picked[use_device] = (ids_u, t_u)
    finally:
        texec._device_sqdist = orig
    rows = sum(n for n, _ in calls)
    check(calls and all(dev_.startswith("cuda") for _, dev_ in calls)
          and rows >= texec._DEVICE_THRESHOLD,
          f"_device_sqdist did not run on the card above the threshold: {calls}")
    check(picked[True][0] == picked[False][0],
          "use_device=True and False give different ids")
    out["device_rescore"] = {"rows": rows // 2, "ms_use_device": picked[True][1],
                             "ms_host": picked[False][1]}
    log(f"phase 8 _device_sqdist at nprobe=32: {rows // 2} candidate rows re-scored on "
        f"the card, ids equal to the host re-score; {picked[True][1]:.1f} ms vs "
        f"{picked[False][1]:.1f} ms a query")

    # The CLI, as subprocesses, against the searcher in this process.
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cli = [sys.executable, "-m", "pqvector_tpu_torch"]
    info = subprocess.run(cli + ["info", path], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)
    check(info.returncode == 0 and f"clusters         : {N_CLUSTERS}" in info.stdout,
          f"CLI info failed: {info.stdout}{info.stderr}")
    row = 4242
    t0 = time.perf_counter()
    srch = subprocess.run(cli + ["search", path, "--query-row", str(row), "-k", str(K),
                                 "--nprobe", str(FRONT_NPROBE), "--device-mode", "auto"],
                          capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    out["cli_search_s"] = time.perf_counter() - t0
    check(srch.returncode == 0, f"CLI search failed: {srch.stderr}")
    cli_ids = [int(line.split("\t")[0]) for line in srch.stdout.strip().splitlines()]
    fp = pqt.DeviceIvfSearcher.from_parquet(path)
    route = fp._unsorted_auto(1, FRONT_NPROBE)
    _, want = fp.search(emb_np[row][None, :], K, FRONT_NPROBE, "auto")
    want = [int(i) for i in want[0].cpu().numpy() if i >= 0]
    check(cli_ids == want, f"CLI search ids {cli_ids} != the searcher's {want}")
    # The SQL host path against the same file's f32 searcher, one batch.
    _, g_ids = fp.search(torch.from_numpy(np.ascontiguousarray(qs)).to(fp.device), K,
                         FRONT_NPROBE, "gather")
    g_ids = g_ids.cpu().numpy()
    out["searcher_recall_at_10"] = ds.recall_at_k(truth_np[:FRONT_QUERIES], g_ids)
    gather_swaps = sum(same_or_tied(g_ids[i], host_ids[i], emb_np, qs[i],
                                    f"phase 8 f32 gather vs SQL query {i}")
                       for i in range(FRONT_QUERIES))
    log(f"phase 8 the f32 searcher's search(gather) on the {FRONT_QUERIES} queries: ids "
        f"of the SQL host path ({gather_swaps} swapped at a tie), recall@{K} "
        f"{out['searcher_recall_at_10']:.4f}")
    out["launches"] = {k_: v for k_, v in _build.LAUNCHES.items() if v}
    check(out["launches"].get("K1", 0) > 0, "K1 was not launched by phase 8's build")
    check(route != "pallas" or out["launches"].get("K6", 0) > 0,
          "search(auto) chose K6 but K6 was not launched")
    out["cli_auto_route"] = route
    log(f"phase 8 CLI: info and search --device-mode auto exit 0; search ids equal "
        f"DeviceIvfSearcher.from_parquet(...).search(q, {K}, {FRONT_NPROBE}, 'auto') "
        f"(route {route}); CLI search {out['cli_search_s']:.1f} s with start-up")
    log(f"phase 8 launches: {out['launches']}")
    del s32, s16, fp
    return out


# --------------------------------------------------------------------------
# Slice 9: spill, dynamic state, autotune, the builds

SPILL, N_DELETE, N_APPEND = 0.2, 10_000, 4096


def recall_of(ds, truth_np, ids):
    return ds.recall_at_k(truth_np, ids.cpu().numpy() if hasattr(ids, "cpu") else ids)


def distinct_ids(ids, what):
    for r in ids:
        vals = r[r >= 0]
        check(len(set(vals.tolist())) == len(vals), f"{what}: a row repeats an id")


def phase9_spill(torch, pqt, _build, ds, path, emb_np, queries, q, truth, searcher, chosen,
                 index, out):
    """(a) The spilled layout at SPILL on the phase-3 rows and index."""
    truth_d, truth_ids = truth
    truth_np = truth_ids.cpu().numpy()
    dev = q.device
    t0 = time.perf_counter()
    sp16 = pqt.DeviceIvfSearcher.with_spill(index, emb_np, spill=SPILL, dtype=torch.bfloat16,
                                            row_tile=ROW_TILE, device=dev)
    torch.cuda.synchronize()
    out["spill_build_s"] = time.perf_counter() - t0
    extra = sp16.n - ROWS
    check(extra == round(SPILL * ROWS), f"with_spill added {extra} rows")
    log(f"phase 9a with_spill({SPILL}) bf16 + f32 copy: {extra} extra rows, "
        f"{sp16.emb.shape[0]} padded, built in {out['spill_build_s']:.2f} s")
    sweep, nprobe_s, nprobe = {}, None, 1
    while nprobe <= N_CLUSTERS:
        before = _build.LAUNCHES["K4"]
        _, ids_sp = sp16.search(q, K, nprobe, "auto")
        check(_build.LAUNCHES["K4"] == before + 1, "spilled search(auto) did not take K4")
        r_sp = recall_of(ds, truth_np, ids_sp)
        r_pl = recall_of(ds, truth_np, searcher.search(q, K, nprobe, "auto")[1])
        sweep[nprobe] = {"spilled": r_sp, "unspilled": r_pl}
        log(f"phase 9a search(auto) nprobe={nprobe}: recall@{K} spilled {r_sp:.4f}, "
            f"unspilled {r_pl:.4f}")
        check(r_sp >= r_pl - 0.002, f"spilled recall {r_sp} under unspilled {r_pl}")
        if r_sp >= RECALL_TARGET:
            nprobe_s = nprobe
            break
        nprobe *= 2
    check(nprobe_s is not None, f"spilled recall never reached {RECALL_TARGET}")
    out["sweep"], out["nprobe"] = sweep, nprobe_s
    _, ids_a = sp16.search(q, K, nprobe_s, "auto")
    ids_a = ids_a.cpu().numpy()
    check((ids_a >= 0).all(), "spilled search(auto) left an empty slot")
    distinct_ids(ids_a, "spilled search(auto)")
    before = _build.LAUNCHES["K3"]
    _, ids_st = sp16.search(q, K, nprobe_s, "stream")
    check(_build.LAUNCHES["K3"] > before, "spilled search(stream) did not take K3")
    ids_st = ids_st.cpu().numpy()
    distinct_ids(ids_st, "spilled search(stream)")
    swaps = sum(same_or_tied(ids_st[i], ids_a[i], emb_np, queries[i],
                             f"phase 9a spilled K3 vs K4 query {i}") for i in range(BATCH))
    log(f"phase 9a nprobe={nprobe_s}: no row repeats an id; K3 (stream) gives K4's ids "
        f"({swaps} slots swapped at a tie)")

    t0 = time.perf_counter()
    sp32 = pqt.DeviceIvfSearcher.with_spill(index, emb_np, spill=SPILL, row_tile=ROW_TILE,
                                            device=dev)
    before = _build.LAUNCHES["K2"]
    got = sp32.exact(q, K, "stream")
    check(_build.LAUNCHES["K2"] > before, "spilled exact(stream) did not take K2")
    swaps = ids_equal_or_tied(got, truth, "phase 9a f32 spilled exact(stream)")
    log(f"phase 9a f32 spilled exact(stream) (K2 at k={2 * K}): the K2 truth "
        f"({swaps} slots swapped at a tie)")
    del sp32
    fp = pqt.DeviceIvfSearcher.from_parquet(path, dtype=torch.bfloat16, row_tile=ROW_TILE,
                                            spill=SPILL, device=dev)
    _, ids_fp = fp.search(q, K, nprobe_s, "auto")
    check(np.array_equal(ids_fp.cpu().numpy(), ids_a),
          "from_parquet(spill) and with_spill give different ids")
    del fp
    torch.cuda.empty_cache()
    log(f"phase 9a from_parquet(path, spill={SPILL}) gives with_spill's ids")

    nprobe_b = nprobe_s
    while True:
        ctile, cap = sp16.calibrate_bincompact(q, nprobe_b, K)
        check(ctile > 0, "spilled bincompact is ineligible")
        before = _build.LAUNCHES["K8"]
        _, ids_b = sp16.search(q, K, nprobe_b, "bincompact")
        check(_build.LAUNCHES["K8"] > before, "spilled bincompact did not take K8")
        r_b = recall_of(ds, truth_np, ids_b)
        distinct_ids(ids_b.cpu().numpy(), "spilled bincompact")
        log(f"phase 9a bincompact (K8) nprobe={nprobe_b}: tile={ctile}, cap={cap}, "
            f"recall@{K} {r_b:.4f}")
        if r_b >= RECALL_TARGET or nprobe_b >= N_CLUSTERS:
            break
        nprobe_b *= 2
    check(r_b >= RECALL_TARGET, f"spilled bincompact recall {r_b}")
    out["bincompact"] = {"nprobe": nprobe_b, "recall": r_b}
    ms_sp = time_ms(lambda: sp16.search(q, K, nprobe_s, "auto"))
    ms_sp_eq = time_ms(lambda: sp16.search(q, K, chosen, "auto"))
    ms_pl = time_ms(lambda: searcher.search(q, K, chosen, "auto"))
    out["ms"] = {f"spilled_nprobe{nprobe_s}": ms_sp, f"spilled_nprobe{chosen}": ms_sp_eq,
                 f"unspilled_nprobe{chosen}": ms_pl}
    out["profile"] = profile_modes(torch, [
        (f"search(auto) spilled nprobe={nprobe_s}",
         lambda: sp16.search(q, K, nprobe_s, "auto")),
        (f"search(auto) unspilled nprobe={chosen}",
         lambda: searcher.search(q, K, chosen, "auto"))])
    log(f"phase 9a search(auto) B={BATCH}: spilled nprobe={nprobe_s} {ms_sp:.3f} ms "
        f"({BATCH / ms_sp * 1e3:.0f} QPS), spilled nprobe={chosen} {ms_sp_eq:.3f} ms, "
        f"unspilled nprobe={chosen} {ms_pl:.3f} ms ({BATCH / ms_pl * 1e3:.0f} QPS)")
    del sp16
    torch.cuda.empty_cache()


def phase9_autotune(torch, searcher, queries, out):
    """(c) autotune on the sorted bf16 searcher, before (b) changes it."""
    from pqvector_tpu_torch.query import autotune

    t0 = time.perf_counter()
    rep = autotune(searcher, queries, k=K, recall_target=RECALL_TARGET, reps=4, budget_s=0.5)
    out["autotune_s"] = time.perf_counter() - t0
    for p in rep.plans:
        log(f"phase 9c plan {p.mode} nprobe={p.nprobe}: recall@{K} {p.recall:.4f}, "
            f"{p.qps:.0f} QPS")
    for mode, why in rep.rejected.items():
        log(f"phase 9c rejected {mode}: {why}")
    modes = {p.mode for p in rep.plans}
    check(all(p.recall >= RECALL_TARGET for p in rep.plans), "a plan misses the target")
    check("gather" not in modes, "gather is in a plan")
    check({"pallas", "stream"} <= modes, f"pallas and stream are not both plans: {modes}")
    out["plans"] = [(p.mode, p.nprobe, p.recall, p.qps) for p in rep.plans]
    out["rejected"] = rep.rejected
    log(f"phase 9c autotune in {out['autotune_s']:.1f} s: best {rep.best.mode} "
        f"nprobe={rep.best.nprobe}")


def plain_topk(torch, q, rows, victims, sq=None):
    """Top-K ids of a plain f32 scan on the card over ``rows`` with the
    ``victims`` rows left out, scoring |x|^2 - 2 q.x with the squared norms
    ``sq`` where given, else the rows' own."""
    x = torch.from_numpy(rows).to(q.device)
    sq = (x * x).sum(dim=1) if sq is None else torch.from_numpy(sq).to(q.device)
    sq[torch.from_numpy(victims).to(q.device)] = torch.inf
    best_d = best_i = None
    step = 1 << 18
    for lo in range(0, x.shape[0], step):
        vals, idx = torch.topk(sq[None, lo:lo + step] - 2.0 * (q @ x[lo:lo + step].T), K,
                               dim=1, largest=False)
        idx = idx + lo
        if best_d is not None:
            vals, idx = torch.cat([best_d, vals], 1), torch.cat([best_i, idx], 1)
        order = torch.topk(vals, K, dim=1, largest=False).indices
        best_d, best_i = vals.gather(1, order), idx.gather(1, order)
    return best_i.cpu().numpy()


def bf16_selection_check(torch, got, got_d, want, rows, sq, queries):
    """Hold a bf16 searcher's exact top-K (ids ``got``, distances ``got_d``)
    to a plain f32 scan's (``want``) over ``rows``, file rows then appended
    rows (already bf16-rounded), ids their positions, with squared norms
    ``sq``. Squared distances are |x|^2 - 2 q.x + |q|^2 in f64, floored at
    0: for an appended row its f32 norm against its bf16 row, the form the
    searcher scores. A tie is 1e-5 (|q|^2 + max|x|^2), above f32's
    expanded-form error. Each returned distance is its row's. A slot of the
    scan missing from the result is a tie with every returned row, or a
    file row that bf16 selection could leave out: each returned file row
    farther than it scores at most as low at storage precision (|x|^2 in
    f32 less 2 bf16(q).bf16(x)), to 2e-5 (2|q| max|x| + max|x|^2), twice
    the error bound of an f32 sum of 128 bf16 products. The appended rows
    are scanned exactly, so none may be missing but at a tie.
    -> (slots swapped at a tie, slots swapped by bf16 selection)."""
    def bf16(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).double().numpy()

    xmax2 = float(sq.max())
    ties = sel = 0
    for i in range(got.shape[0]):
        qi = queries[i].astype(np.float64)
        q2 = float(qi @ qi)
        tie = 1e-5 * (q2 + xmax2)
        delta = 2e-5 * (2.0 * np.sqrt(q2 * xmax2) + xmax2)
        d2 = lambda ids: np.maximum(  # noqa: E731
            sq[ids].astype(np.float64) - 2.0 * rows[ids].astype(np.float64) @ qi + q2, 0.0)
        dg = d2(got[i])
        check(np.allclose(got_d[i].astype(np.float64) ** 2, dg, rtol=0, atol=tie),
              f"bf16 exact(stream) query {i}: distances {got_d[i] ** 2} are not the rows' {dg}")
        missing = np.setdiff1d(want[i], got[i])
        if missing.size == 0:
            continue
        main = got[i][got[i] < ROWS]
        est = lambda ids: (sq[ids].astype(np.float64)  # noqa: E731
                           - 2.0 * bf16(rows[ids]) @ bf16(queries[i]))
        for w in missing:
            dw = d2(np.array([w]))[0]
            if (dg <= dw + 2 * tie).all():
                ties += 1
                continue
            check(w < ROWS, f"bf16 exact(stream) query {i}: appended row {w} is missing")
            farther = main[d2(main) > dw + 2 * tie]
            ew = est(np.array([w]))[0]
            check((est(farther) <= ew + 2 * delta).all(),
                  f"bf16 exact(stream) query {i}: row {w} lost to rows {farther} that score "
                  f"{est(farther)} against its {ew} at storage precision")
            sel += 1
    return ties, sel


def phase9_dynamic(torch, _build, ds, emb_np, queries, q, truth_np, searcher, truth_s,
                   chosen, out):
    """(b) deletes and appends on the sorted bf16 searcher, every mode; the
    same updates on the f32 truth searcher, whose exact(stream) must equal
    a plain f32 scan over the live and appended rows."""
    out["plain_auto_ms"] = time_ms(lambda: searcher.search(q, K, chosen, "auto"))
    r16_before = ds.recall_at_k(truth_np, searcher.exact(q, K, "stream")[1].cpu().numpy())
    rng = np.random.default_rng(9)
    must = np.unique(truth_np[:64, 0])
    others = rng.choice(np.setdiff1d(np.arange(ROWS), must), N_DELETE - must.size,
                        replace=False)
    victims = np.concatenate([must, others])
    modes = np.random.default_rng(1234).uniform(-1.0, 1.0, (256, DIM)).astype(np.float32)
    rng = np.random.default_rng(11)  # rows drawn as the file's (datasets.generate_dataset)
    drawn = (modes[rng.integers(0, 256, N_APPEND - BATCH)] + 0.15 * rng.standard_normal(
        (N_APPEND - BATCH, DIM)).astype(np.float32))
    app = np.concatenate([queries + np.float32(1e-3), drawn]).astype(np.float32)
    for s in (searcher, truth_s):
        s.delete_rows(victims)
        new_ids = s.append_rows(app)
        check(np.array_equal(new_ids, ROWS + np.arange(N_APPEND)), "append_rows ids")
    log(f"phase 9b deleted {victims.size} rows (the K2 top-1 of the first 64 queries "
        f"among them), appended {N_APPEND} (the {BATCH} queries + 1e-3 and "
        f"{N_APPEND - BATCH} drawn as the file's rows), on the sorted bf16 searcher and "
        f"the f32 truth searcher")

    ctile, _ = searcher.calibrate_bincompact(q, chosen, K)
    check(ctile > 0, "bincompact ineligible after the updates")
    calls = {
        "search(auto)": lambda: searcher.search(q, K, chosen, "auto"),
        "search(stream)": lambda: searcher.search(q, K, chosen, "stream"),
        "search(binscan)": lambda: searcher.search(q, K, chosen, "binscan"),
        "search(bincompact)": lambda: searcher.search(q, K, chosen, "bincompact"),
        "exact(stream)": lambda: searcher.exact(q, K, "stream"),
        "exact(pallas)": lambda: searcher.exact(q, K, "pallas"),
        "exact(cert)": lambda: searcher.exact(q, K, "cert"),
        "f32 exact(stream)": lambda: truth_s.exact(q, K, "stream"),
    }
    results, dists = {}, {}
    for name, fn in calls.items():
        d, ids = fn()
        ids = ids.cpu().numpy()
        check(not np.isin(ids, victims).any(), f"{name}: a deleted id came back")
        check((ids >= 0).all(), f"{name}: an empty slot where live rows exist")
        check(np.array_equal(ids[:, 0], new_ids[:BATCH]),
              f"{name}: a query's top-1 is not its appended copy")
        results[name], dists[name] = ids, d.float().cpu().numpy()
    rows32 = np.concatenate([emb_np, app])
    want = plain_topk(torch, q, rows32, victims)
    swaps = sum(same_or_tied(results["f32 exact(stream)"][i], want[i], rows32, queries[i],
                             f"phase 9b f32 exact(stream) vs the plain f32 scan, query {i}")
                for i in range(BATCH))
    # The bf16 searcher keeps its appended rows rounded to bf16 beside their
    # f32 norms (as the JAX package does), and selects its file rows at bf16
    # before an f32 re-score: against a plain f32 scan over the file rows and
    # the bf16-rounded appended rows with those norms, a slot may differ only
    # at a tie or where bf16 selection could rank the rows so.
    app16 = torch.from_numpy(app).to(torch.bfloat16).float().numpy()
    rows16 = np.concatenate([emb_np, app16])
    sq16 = np.concatenate([np.einsum("nd,nd->n", emb_np, emb_np),
                           np.einsum("nd,nd->n", app, app)])
    want16 = plain_topk(torch, q, rows16, victims, sq=sq16)
    ties16, sel16 = bf16_selection_check(
        torch, results["exact(stream)"], dists["exact(stream)"], want16, rows16, sq16,
        queries)
    r16 = ds.recall_at_k(want16, results["exact(stream)"])
    out["bf16_exact_vs_plain"] = {"recall_before": r16_before, "recall": r16,
                                  "tie_swaps": ties16, "bf16_selection_swaps": sel16}
    log(f"phase 9b {', '.join(calls)}: no deleted id, no empty slot, each query's top-1 "
        f"its appended copy; f32 exact(stream) equals the plain f32 scan over the live "
        f"and appended rows ({swaps} slots swapped at a tie); bf16 exact(stream) against "
        f"the plain f32 scan over the live and bf16-rounded appended rows: distances "
        f"equal, {ties16} slots swapped at a tie, {sel16} by bf16 selection, recall@{K} "
        f"{r16:.4f} ({r16_before:.4f} against the K2 truth before the updates)")
    out["dynamic_auto_ms"] = time_ms(lambda: searcher.search(q, K, chosen, "auto"))
    out["profile"] = profile_modes(torch, [
        (f"search(auto) bf16 nprobe={chosen}, dynamic state",
         lambda: searcher.search(q, K, chosen, "auto"))])
    log(f"phase 9b search(auto) B={BATCH} nprobe={chosen}: {out['plain_auto_ms']:.3f} ms "
        f"plain, {out['dynamic_auto_ms']:.3f} ms with {victims.size} tombstones and a "
        f"{N_APPEND}-row delta (_finalize)")


def phase9_builds(torch, pqt, _build, ds, path, emb_np, q, truth_np, index, r8,
                  phase3_stages, data_dir, out):
    """(d) The staged, build_new, cluster-sorted and streaming builds, each
    on a copy of the phase-3 file."""
    import pyarrow.parquet as pq

    from pqvector_tpu_torch.index.streaming import (
        assign_clusters_streaming,
        iter_embedding_batches,
    )
    from pqvector_tpu_torch.io.embed import read_index_from_parquet
    from pqvector_tpu_torch.io.reader import extract_embeddings, read_embedding_column
    from pqvector_tpu_torch.types import EmbeddingColumn
    from pqvector_tpu_torch.utils.profiling import drain_stages

    dev = q.device
    col = EmbeddingColumn("embedding")

    def copy(name):
        dst = os.path.join(data_dir, name)
        shutil.copy(path, dst)
        return dst

    def builder(p):
        return pqt.IndexBuilder(p, "embedding", device=dev).n_clusters(N_CLUSTERS)

    p1 = copy("staged.parquet")
    drain_stages()
    t0 = time.perf_counter()
    idx = builder(p1).build_inplace()
    out["staged_s"] = time.perf_counter() - t0
    stages = dict(drain_stages())
    check(idx.to_bytes() == index.to_bytes(), "staged build_inplace differs from phase 3")
    t0 = time.perf_counter()
    extract_embeddings(pq.read_table(p1, columns=["embedding"]), col)
    pyarrow_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    read_embedding_column(p1, col)
    native_s = time.perf_counter() - t0
    out["stages"] = {"phase9": stages, "phase3": phase3_stages,
                     "read_pyarrow_s": pyarrow_s, "read_native_s": native_s}
    log(f"phase 9d staged build_inplace in {out['staged_s']:.2f} s, index bytes equal "
        "phase 3's; stages " + ", ".join(f"{k_} {v:.3f}" for k_, v in stages.items())
        + " s; phase 3 " + ", ".join(f"{k_} {v:.3f}" for k_, v in phase3_stages.items())
        + f" s; the column alone: pyarrow {pyarrow_s:.3f} s, native decoder "
        f"{native_s:.3f} s")
    os.remove(p1)

    out1 = os.path.join(data_dir, "new.parquet")
    t0 = time.perf_counter()
    idx = builder(path).build_new(out1)
    out["build_new_s"] = time.perf_counter() - t0
    check(idx.to_bytes() == index.to_bytes(), "build_new's index differs from phase 3")
    check(read_index_from_parquet(out1)[0].to_bytes() == index.to_bytes(),
          "build_new's file holds another index")
    back = pq.read_table(out1)
    check(back.num_rows == ROWS and back.column_names == ["id", "embedding"],
          "pyarrow does not read build_new's file back")
    del back
    os.remove(out1)
    log(f"phase 9d build_new in {out['build_new_s']:.2f} s: index bytes equal phase 3's; "
        "pyarrow reads the file back")

    out2 = os.path.join(data_dir, "sorted.parquet")
    t0 = time.perf_counter()
    idx = builder(path).cluster_sorted().build_new(out2)
    out["cluster_sorted_s"] = time.perf_counter() - t0
    check(np.array_equal(idx.centroids, index.centroids)
          and np.array_equal(idx.cluster_sizes(), index.cluster_sizes()),
          "cluster-sorted build_new: other centroids or list sizes")
    order = np.asarray(index.row_ids, np.int64)
    check(np.array_equal(read_embedding_column(out2, col).data, emb_np[order]),
          "cluster-sorted rows are not permuted as index.row_ids orders them")
    s2 = pqt.DeviceIvfSearcher.from_parquet(out2, dtype=torch.bfloat16, row_tile=ROW_TILE,
                                            device=dev)
    _, pos = s2.search(q, K, 8, "auto")
    pos = pos.cpu().numpy()
    r_sorted = recall_of(ds, truth_np, np.where(pos >= 0, order[np.maximum(pos, 0)], -1))
    check(abs(r_sorted - r8) <= 0.002, f"cluster-sorted file recall {r_sorted} vs {r8}")
    del s2
    os.remove(out2)
    log(f"phase 9d cluster_sorted().build_new in {out['cluster_sorted_s']:.2f} s: same "
        f"centroids and list sizes, rows in index.row_ids order; from_parquet serves "
        f"search(auto) nprobe=8 at recall@{K} {r_sorted:.4f} (phase 3 {r8:.4f})")

    pa_, pb_ = copy("stream_a.parquet"), copy("stream_b.parquet")
    t0 = time.perf_counter()
    ia = builder(pa_).streaming(131072).build_inplace()
    out["streaming_s"] = time.perf_counter() - t0
    ib = builder(pb_).streaming(131072).build_inplace()
    check(ia.to_bytes() == ib.to_bytes(), "two streaming builds with one seed differ")
    n_batches = sum(1 for _ in iter_embedding_batches(pa_, col, 131072))
    before = _build.LAUNCHES["K1"]
    assign = assign_clusters_streaming(pa_, col, ia.centroids, 131072, device=dev)
    check(_build.LAUNCHES["K1"] - before == n_batches,
          f"K1 ran {_build.LAUNCHES['K1'] - before} times for {n_batches} batches")
    check(type(ia).from_assignments(ia.centroids, assign).to_bytes() == ia.to_bytes(),
          "the streamed assignment is not the streaming build's")
    ss = pqt.DeviceIvfSearcher(ia, emb_np, dtype=torch.bfloat16, row_tile=ROW_TILE,
                               cluster_sorted=True, device=dev)
    r_stream = recall_of(ds, truth_np, ss.search(q, K, 8, "auto")[1])
    check(abs(r_stream - r8) <= 0.01, f"streaming build recall {r_stream} vs {r8}")
    del ss
    os.remove(pa_)
    os.remove(pb_)
    out["streaming"] = {"batches": n_batches, "recall_nprobe8": r_stream}
    log(f"phase 9d streaming(131072).build_inplace in {out['streaming_s']:.2f} s: two "
        f"builds with one seed give identical bytes; K1 once per batch ({n_batches}); "
        f"recall@{K} at nprobe=8 {r_stream:.4f} (phase 3 {r8:.4f})")


def phase9(torch, pqt, _build, ds, path, emb_np, queries, q, truth, truth_s, searcher, chosen,
           index, phase3_stages, data_dir, card):
    """Slice 9's path on the phase-3 file and index: (a) the spilled layout,
    (c) autotune, (b) deletes and appends (after (c), which wants the file's
    rows), (d) the builds. Launch counts start at 0 here."""
    t_phase = time.perf_counter()
    truth_np = truth[1].cpu().numpy()
    out = {}
    _build.reset_launches()
    r8 = recall_of(ds, truth_np, searcher.search(q, K, 8, "auto")[1])
    out["spill"] = {}
    phase9_spill(torch, pqt, _build, ds, path, emb_np, queries, q, truth, searcher, chosen,
                 index, out["spill"])
    phase9_autotune(torch, searcher, queries, out)
    out["dynamic"] = {}
    phase9_dynamic(torch, _build, ds, emb_np, queries, q, truth_np, searcher, truth_s, chosen,
                   out["dynamic"])
    torch.cuda.empty_cache()
    phase9_builds(torch, pqt, _build, ds, path, emb_np, q, truth_np, index, r8,
                  phase3_stages, data_dir, out)
    out["launches"] = {k_: v for k_, v in _build.LAUNCHES.items() if v}
    for name in ("K1", "K2", "K3", "K4", "K5", "K7", "K8", "K9", "K10"):
        check(out["launches"].get(name, 0) > 0, f"{name} was not launched in phase 9")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 9 launches {out['launches']}; {out['seconds']:.1f} s on {card}")
    return out


# --------------------------------------------------------------------------
# Slice 10: dist/ over a one-process mesh (K1, K2, K3, K7, K8 per shard)

N_SHARDS, N_DIST_DELETE = 4, 1000


def nearer_or_tied(got, want, what):
    """``got`` (sqrt distances [B, k], ids, numpy) selected from a superset
    of ``want``'s candidates and ranked on the same f32 distances: every
    slot of ``got`` is at least as near as ``want``'s, to 1e-5 relative.
    -> (slots whose ids differ at a tie, slots where ``got`` is nearer)."""
    gd, gi = got
    wd, wi = want
    check(bool((gd <= wd * (1 + 1e-5) + 1e-6).all()), f"{what}: a slot is farther")
    differ = gi != wi
    tied = differ & np.isclose(gd, wd, rtol=1e-5, atol=1e-6)
    return int(tied.sum()), int((differ & ~tied).sum())


def uncounted(_build, fn):
    """fn() with every launch count as it was before: launches made to hold
    a kernel to its plain version are not the path's."""
    saved = dict(_build.LAUNCHES)
    try:
        return fn()
    finally:
        _build.LAUNCHES.update(saved)


def phase10_k1(torch, ka, meshes, sample, c0, emb_np, index, out):
    """K1 at the shapes shard 0 of four gives it (its padded block of the
    training sample against the initial centroids, and of the 1M rows
    against the index's centroids) against the plain version: ids equal
    except near ties, as phase 2b holds K1 at 1M rows."""
    from pqvector_tpu_torch.dist.kmeans import _shard_rows_padded

    res = {}
    for label, rows, cents in (("sample", sample, c0), ("rows", emb_np, index.centroids)):
        xs, _, _ = _shard_rows_padded(rows, meshes[4], 8192)
        x0, c = xs[0], torch.from_numpy(np.asarray(cents, np.float32)).to(xs[0].device)
        del xs
        differ, gap = assign_near_ties(torch, x0, c, ka.assign_rows(x0, c),
                                       ka.assign_rows_plain(x0, c), f"shard 0 K1 {label}")
        res[label] = {"rows": x0.shape[0], "differ": differ, "max_abs_err": gap}
    out["shard0_K1"] = res
    log(f"phase 10b K1 on shard 0 of {N_SHARDS} against the plain version (ids equal "
        f"except near ties): {res}")


def phase10_k7_k8(torch, bs, s16, q, chosen, out):
    """K7 (bf16 and int8) and K8 at the shapes shard 0 of four gives them,
    against their plain versions as phase 2b holds them: bf16 key tables
    within compare_tables' tolerance, the int8 table bit for bit. K8 runs on
    the tiles the searcher selects, at the calibrated cap (every tile of the
    shard at this batch and nprobe) and at nprobe 1 with half the shard's
    tiles, where the popularity order chooses."""
    emb, sq = s16.emb[0], s16.emb_sq_pallas[0]
    q64 = q.double().cpu().numpy()
    sq64 = sq.cpu().numpy().astype(np.float64)
    res = {}
    t7 = s16._binscan_tile()
    args = (q, emb, sq, t7)
    err, swaps = compare_tables(bs.binned_scan_keys(*args), bs.binned_scan_keys_plain(*args),
                                q64, sq64, bs.provenance_bits(emb.shape[0] // t7, t7))
    res["K7_bf16"] = {"tile": t7, "max_abs_err": err, "bins_differ": swaps}
    e8, sc8 = s16._xbin8_arrays()
    t8 = s16._binscan_tile(esize=1)
    args8 = (q, e8[0], sq, t8, 1, sc8[0])
    check(torch.equal(bs.binned_scan_keys(*args8), bs.binned_scan_keys_plain(*args8)),
          "shard 0 K7 int8: key table differs from plain")
    res["K7_int8"] = {"tile": t8, "equal": True}
    nt = s16._nt_local
    for label, nprobe, cap in (("calibrated", chosen, s16._bincompact_calibrated[0]),
                               ("nprobe1", 1, nt // 2)):
        sel = s16._bincompact_sel(0, q, nprobe, cap)
        check(sel.shape[0] == cap and int(sel.unique().numel()) == cap,
              f"shard 0 K8 {label}: sel is not {cap} distinct tiles")
        s_args = (q, emb, sq, sel, s16.tile)
        err, swaps = compare_tables(bs.binned_scan_select_keys(*s_args),
                                    bs.binned_scan_select_keys_plain(*s_args), q64, sq64,
                                    bs.provenance_bits(cap, s16.tile))
        res[f"K8_{label}"] = {"nprobe": nprobe, "cap": cap, "tiles": nt,
                              "max_abs_err": err, "bins_differ": swaps}
    out["shard0_kernels"] = res
    log(f"phase 10c K7/K8 on shard 0 of {N_SHARDS} against their plain versions: {res}")


def launched(_build, name, fn):
    """(fn(), launches of kernel ``name`` during it)."""
    before = _build.LAUNCHES[name]
    res = fn()
    return res, _build.LAUNCHES[name] - before


def check_shard_launches(n, dev, what, calls=1):
    """A sharded call on the card launches its kernel once a shard for each
    of ``calls`` calls (``None``: any positive number of calls); on the CPU
    (a rehearsal) the plain versions launch nothing."""
    if dev.type != "cuda":
        check(n == 0, f"{what}: {n} launches on the CPU")
    elif calls is None:
        check(n > 0 and n % N_SHARDS == 0, f"{what}: {n} launches on {N_SHARDS} shards")
    else:
        check(n == calls * N_SHARDS, f"{what}: {n} launches on {N_SHARDS} shards")


def phase10_build(torch, pqt, _build, ds, dist, emb_np, queries, truth_np, index, r8,
                  meshes, out):
    """(a) the sharded build on four shards of one card against one shard
    and phase 3's single build, and served as phase 3 serves its index;
    (b) distributed_lloyd against _lloyd from the single build's initial
    centroids. The block sums add in row order whatever the shards, so each
    pair must agree bit for bit. Then K1 at shard 0's shapes against its
    plain version."""
    from pqvector_tpu_torch.index.kmeans import (
        _kmeans_pp_init,
        _lloyd,
        init_key,
        sample_indices_host,
        train_sample_size,
    )
    from pqvector_tpu_torch.kernels import assign as ka
    from pqvector_tpu_torch.types import Embeddings

    cfg = pqt.IvfBuildConfig(n_clusters=N_CLUSTERS)
    built = {}
    for label, mesh in (("4", meshes[4]), ("1", meshes[1])):
        t0 = time.perf_counter()
        built[label], k1 = launched(_build, "K1", lambda: dist.build_ivf_index_distributed(
            Embeddings(emb_np, DIM), cfg, mesh=mesh))
        out[f"build{label}_s"] = time.perf_counter() - t0
        out[f"build{label}_K1"] = k1
    i4, i1 = built["4"], built["1"]
    check(i4.to_bytes() == i1.to_bytes(), "sharded build: 4 and 1 shards differ")
    # At 1M rows the training sample is the single build's init-sample cap
    # (50k), so the single build seeds and trains on the same rows.
    check(i4.to_bytes() == index.to_bytes(), "sharded build: index bytes differ from "
          "phase 3's single build")
    # served as phase 3 serves its index: the sorted bf16 searcher, auto
    s4 = pqt.DeviceIvfSearcher(i4, emb_np, dtype=torch.bfloat16, row_tile=ROW_TILE,
                               cluster_sorted=True, device=meshes[4].devices[0])
    r8_4 = ds.recall_at_k(truth_np, s4.search(queries, K, 8)[1].cpu().numpy())
    out["recall_nprobe8"] = r8_4
    check(abs(r8_4 - r8) <= 0.01, f"sharded build: recall@{K} at nprobe 8 {r8_4} against "
          f"phase 3's {r8}")
    del s4
    log(f"phase 10a build_ivf_index_distributed {ROWS} x {DIM}, IVF-{N_CLUSTERS}: 4 shards "
        f"{out['build4_s']:.2f} s (K1 {out['build4_K1']}), 1 shard {out['build1_s']:.2f} s "
        f"(K1 {out['build1_K1']}); index bytes equal to each other and to phase 3's "
        f"single build; recall@{K} at nprobe 8 {r8_4:.4f} (phase 3 {r8:.4f})")

    dev = meshes[4].devices[0]
    n_sample = train_sample_size(ROWS, N_CLUSTERS)  # phase 3's training sample
    sample = emb_np[sample_indices_host(42 ^ 0x5A5A5A5A, ROWS, n_sample)]
    xs = torch.from_numpy(sample).to(dev)
    c0 = _kmeans_pp_init(xs, init_key(42), N_CLUSTERS)
    (cd, ad), k1 = launched(_build, "K1", lambda: dist.distributed_lloyd(
        sample, c0.cpu().numpy(), 20, mesh=meshes[4], block_rows=8192))
    cs, as_ = _lloyd(xs, c0, 20, 8192, N_CLUSTERS)
    cs, as_ = cs.cpu().numpy(), as_.cpu().numpy()
    out["lloyd"] = {"K1": k1, "assign_differ": int((ad != as_).sum()),
                    "centroid_bits_equal": cd.tobytes() == cs.tobytes()}
    check(out["lloyd"]["assign_differ"] == 0 and out["lloyd"]["centroid_bits_equal"],
          f"distributed_lloyd against _lloyd: {out['lloyd']}")
    check_shard_launches(k1, dev, "distributed_lloyd, K1", calls=None)
    log(f"phase 10b distributed_lloyd (4 shards) against _lloyd, {n_sample} x {DIM}, "
        f"{N_CLUSTERS} clusters, 20 iterations from the single build's initial "
        f"centroids: {out['lloyd']}")
    uncounted(_build, lambda: phase10_k1(torch, ka, meshes, sample, c0.cpu().numpy(),
                                          emb_np, index, out))


def phase10_serve(torch, pqt, _build, ds, dist, emb_np, queries, q, truth, index, chosen,
                  meshes, out):
    """(c) the sharded searchers on phase 3's index: K3, the gather chain,
    K7, K8 and K2 on each of four shards of one card, held to the
    single-device searcher, to each other and to the K2 truth; the 2 x 2
    mesh; the spilled layout; times at 1 and 4 shards."""
    from pqvector_tpu_torch.kernels import binscan as bs

    dev = meshes[4].devices[0]
    truth_np = truth[1].cpu().numpy()
    m4 = meshes[4]
    s16 = dist.DistributedIvfSearcher(index, emb_np, mesh=m4, dtype=torch.bfloat16)
    s32 = dist.DistributedIvfSearcher(index, emb_np, mesh=m4)
    single16 = pqt.DeviceIvfSearcher(index, emb_np, dtype=torch.bfloat16, row_tile=ROW_TILE,
                                      cluster_sorted=True, device=dev)
    single32 = pqt.DeviceIvfSearcher(index, emb_np, row_tile=ROW_TILE, cluster_sorted=True,
                                     device=dev)
    out["layout"] = {"rows_per_shard": s16._rows_per_dev, "tiles_per_shard": s16._nt_local,
                     "cmax": s16._cmax}

    def np_of(res):
        return res[0].float().cpu().numpy(), res[1].cpu().numpy()

    def as_t(res):
        return torch.from_numpy(res[0]), torch.from_numpy(res[1])

    fused16, k3 = launched(_build, "K3", lambda: s16.search_fused(queries, K, chosen))
    check_shard_launches(k3, dev, "search_fused, K3")
    fused32 = s32.search_fused(queries, K, chosen)
    stream32 = np_of(single32.search(q, K, chosen, "stream"))
    swaps32 = ids_equal_or_tied(as_t(fused32), as_t(stream32),
                                "f32 search_fused against single search(stream)")
    ties16, nearer16 = nearer_or_tied(fused16, np_of(single16.search(q, K, chosen, "stream")),
                                      "bf16 search_fused against single search(stream)")
    # the single searcher's selection at 2k, re-scored, cut to k: what a
    # shard's fetch does on one device
    rec_2k = ds.recall_at_k(truth_np, single16._search_impl(q, 2 * K, chosen, "stream")[1]
                            [:, :K].cpu().numpy())
    gather32 = s32.search(queries, K, chosen)
    gswaps32 = ids_equal_or_tied(as_t(gather32), as_t(fused32), "f32 search against fused")
    gather16 = s16.search(queries, K, chosen)
    gswaps16 = ids_equal_or_tied(as_t(gather16), as_t(fused16), "bf16 search against fused")
    rec = {name: ds.recall_at_k(truth_np, res[1]) for name, res in (
        ("fused16", fused16), ("gather16", gather16), ("fused32", fused32))}
    rec["single16_stream"] = ds.recall_at_k(truth_np, single16.search(q, K, chosen, "stream")
                                            [1].cpu().numpy())
    rec["single16_stream_2k"] = rec_2k
    out["search"] = {"nprobe": chosen, "recall": rec, "f32_fused_vs_stream_tie_swaps": swaps32,
                     "bf16_fused_vs_stream": {"ties": ties16, "nearer": nearer16},
                     "f32_gather_vs_fused_tie_swaps": gswaps32,
                     "bf16_gather_vs_fused_tie_swaps": gswaps16}
    log(f"phase 10c search_fused (K3 x {N_SHARDS}) nprobe={chosen}: f32 ids = single "
        f"search(stream)'s ({swaps32} tie swaps); bf16 + f32 copy: every slot at least as "
        f"near as single search(stream)'s ({ties16} tie swaps, {nearer16} nearer by the "
        f"2k fetch a shard); search (gather) = search_fused on f32 ({gswaps32} tie swaps) "
        f"and on bf16 ({gswaps16}); recall@{K} {rec}")

    for name, fn, kern in (
        ("binscan", lambda: s16.search_binscan(queries, K), "K7"),
        ("binscan8", lambda: s16.search_binscan8(queries, K), "K7"),
    ):
        res, n = launched(_build, kern, fn)
        check_shard_launches(n, dev, f"search_{name}, {kern}")
        r = ds.recall_at_k(truth_np, res[1])
        check(r >= RECALL_TARGET, f"search_{name} recall@{K} {r}")
        out[name] = {"recall": r, "tile": s16._binscan_tile(1 if name[-1] == "8" else None)}
    r = ds.recall_at_k(truth_np, s16.search_scan(queries, K)[1])
    check(r >= RECALL_TARGET, f"search_scan recall@{K} {r}")
    out["scan"] = {"recall": r}
    cap = s16.calibrate_bincompact(queries, chosen, K)
    check(cap > 0, "calibrate_bincompact: ineligible")
    res, n = launched(_build, "K8", lambda: s16.search_bincompact(queries, K, chosen))
    check_shard_launches(n, dev, "search_bincompact, K8")
    r = ds.recall_at_k(truth_np, res[1])
    check(r >= RECALL_TARGET, f"search_bincompact recall@{K} {r}")
    out["bincompact"] = {"recall": r, "cap": cap, "coverage": cap / s16._nt_local}
    uncounted(_build, lambda: phase10_k7_k8(torch, bs, s16, q, chosen, out))
    cap_low = out["shard0_kernels"]["K8_nprobe1"]["cap"]
    res, n = launched(_build, "K8", lambda: s16.search_bincompact(queries, K, 1,
                                                                  cap=cap_low))
    check_shard_launches(n, dev, f"search_bincompact nprobe=1 cap={cap_low}, K8")
    out["bincompact"]["nprobe1"] = {"cap": cap_low, "recall": ds.recall_at_k(truth_np, res[1])}
    exact4 = dist.DistributedExactSearcher(emb_np, mesh=m4)
    res, n = launched(_build, "K2", lambda: exact4.search(queries, K))
    check_shard_launches(n, dev, "DistributedExactSearcher, K2")
    out["exact_tie_swaps"] = ids_equal_or_tied(as_t(res), (truth[0].cpu(), truth[1].cpu()),
                                               "DistributedExactSearcher against the K2 truth")
    log(f"phase 10c binscan (K7) {out['binscan']}, binscan8 {out['binscan8']}, bincompact "
        f"(K8) {out['bincompact']}, scan {out['scan']}; DistributedExactSearcher (K2 x {N_SHARDS}) = the K2 "
        f"truth ({out['exact_tie_swaps']} tie swaps)")

    c22 = dist.DistributedClusterIvfSearcher(index, emb_np,
                                             mesh=dist.make_mesh_2d(2, 2, device=dev))
    res, n = launched(_build, "K3", lambda: c22.search(queries, K, chosen))
    check_shard_launches(n, dev, "the 2 x 2 searcher, K3")
    out["cluster_2x2_tie_swaps"] = ids_equal_or_tied(as_t(res), as_t(fused32),
                                                     "2 x 2 mesh against the 1-D mesh")
    del c22
    sp = dist.DistributedIvfSearcher.with_spill(index, emb_np, spill=0.2, mesh=m4,
                                                dtype=torch.bfloat16)
    res = sp.search_fused(queries, K, chosen)
    distinct_ids(res[1], "spilled search_fused")
    out["spill"] = {"recall": ds.recall_at_k(truth_np, res[1]), "rows": sp.n}
    del sp
    log(f"phase 10c 2 x 2 (data, cluster) mesh = the 1-D mesh's ids "
        f"({out['cluster_2x2_tie_swaps']} tie swaps); with_spill(0.2): no repeated id, "
        f"recall@{K} {out['spill']['recall']:.4f} at nprobe={chosen}")

    # Times: four shards on one card run one after another, so these show
    # the sharding's overhead, not scaling.
    s16_1 = dist.DistributedIvfSearcher(index, emb_np, mesh=meshes[1], dtype=torch.bfloat16)
    s16_1.calibrate_bincompact(queries, chosen, K)
    exact1 = dist.DistributedExactSearcher(emb_np, mesh=meshes[1])
    times = {}
    for label, s, e in (("1", s16_1, exact1), ("4", s16, exact4)):
        times[label] = {
            "search_fused": time_ms(lambda: s.search_fused(queries, K, chosen)),
            "search_binscan": time_ms(lambda: s.search_binscan(queries, K)),
            "search_bincompact": time_ms(lambda: s.search_bincompact(queries, K, chosen)),
            "exact": time_ms(lambda: e.search(queries, K)),
        }
    times["single"] = {
        "search(stream)": time_ms(lambda: single16.search(q, K, chosen, "stream")),
        "exact(stream)": time_ms(lambda: single32.exact(q, K, "stream")),
    }
    out["ms"] = times
    log(f"phase 10c ms a batch (B={BATCH}, bf16 + f32 copy, exact f32), 1 and "
        f"{N_SHARDS} shards of one card, and the single-device searcher: {times}")
    if dev.type == "cuda":
        out["profile"] = profile_modes(torch, [
            (f"phase 10 search_fused, {N_SHARDS} shards",
             lambda: s16.search_fused(queries, K, chosen)),
            ("phase 10 search_fused, 1 shard", lambda: s16_1.search_fused(queries, K, chosen)),
            (f"phase 10 search_binscan, {N_SHARDS} shards",
             lambda: s16.search_binscan(queries, K)),
        ])
    if torch.cuda.device_count() >= 2:
        out["distinct_cards"] = phase10_distinct(torch, pqt, dist, emb_np, queries, truth,
                                                 index, chosen)
    else:
        out["distinct_cards"] = None
        log("phase 10c one card: distinct-card mesh not run")

    rng = np.random.default_rng(10)
    must = np.unique(truth_np[:, 0])
    victims = np.concatenate([must, rng.choice(np.setdiff1d(np.arange(ROWS), must),
                                               N_DIST_DELETE - must.size, replace=False)])
    s16.delete_rows(victims)
    new_ids = s16.append_rows(queries + np.float32(1e-3))
    check(np.array_equal(new_ids, ROWS + np.arange(BATCH)), "append_rows ids")
    for name, fn in (
        ("search_fused", lambda: s16.search_fused(queries, K, chosen)),
        ("search", lambda: s16.search(queries, K, chosen)),
        ("search_binscan", lambda: s16.search_binscan(queries, K)),
        ("search_bincompact", lambda: s16.search_bincompact(queries, K, chosen)),
    ):
        _, ids = fn()
        check(not np.isin(ids, victims).any(), f"{name}: a deleted id came back")
        check(np.array_equal(ids[:, 0], new_ids), f"{name}: a query's top-1 is not its "
              "appended copy")
    log(f"phase 10c after {victims.size} deletes (every query's K2 top-1 among them) and "
        f"{BATCH} appends (the queries + 1e-3): search_fused, search, search_binscan, "
        f"search_bincompact return no deleted id, each query's appended copy first")


def phase10_distinct(torch, pqt, dist, emb_np, queries, truth, index, chosen):
    """A mesh of distinct cards (``make_mesh()``: every card) against as many
    shards of the first card: the same layout, so K1 (the sharded build),
    K3, K7 and K2 on each card must give the one card's bits, each launched
    under its own card's scope; times of both."""
    from pqvector_tpu_torch.types import Embeddings

    md = dist.make_mesh()
    m1 = dist.make_mesh(md.size, device=torch.device("cuda", 0))
    built = dist.build_ivf_index_distributed(
        Embeddings(emb_np, DIM), pqt.IvfBuildConfig(n_clusters=N_CLUSTERS), mesh=md)
    check(built.to_bytes() == index.to_bytes(),
          f"sharded build over {md.size} cards: index bytes differ from phase 3's")
    res = {"cards": md.size}
    searchers = [(dist.DistributedIvfSearcher(index, emb_np, mesh=m, dtype=torch.bfloat16),
                  dist.DistributedExactSearcher(emb_np, mesh=m)) for m in (md, m1)]
    for name, call in (
        ("search_fused", lambda s, e: s.search_fused(queries, K, chosen)),
        ("search_binscan", lambda s, e: s.search_binscan(queries, K)),
        ("exact", lambda s, e: e.search(queries, K)),
    ):
        (gd, gi), (wd, wi) = (call(*pair) for pair in searchers)
        check(np.array_equal(gi, wi) and gd.tobytes() == wd.tobytes(),
              f"{name}: {md.size} cards differ from {md.size} shards of one card")
        res[name] = {"ms_cards": time_ms(lambda: call(*searchers[0])),
                     "ms_one_card": time_ms(lambda: call(*searchers[1]))}
    res["exact_tie_swaps"] = ids_equal_or_tied(
        tuple(torch.from_numpy(a) for a in searchers[0][1].search(queries, K)),
        (truth[0].cpu(), truth[1].cpu()), f"exact over {md.size} cards against the K2 truth")
    log(f"phase 10c distinct-card mesh of {md.size} cards: the sharded build gives phase "
        f"3's index bytes; search_fused, search_binscan and exact give {md.size} shards "
        f"of one card's bits; ms a batch {res}")
    return res


def phase10(torch, pqt, _build, ds, emb_np, queries, q, truth, index, r8, chosen, card,
            device="cuda:0"):
    """Slice 10's path on the phase-3 rows and index, launch counts from 0:
    the sharded build and Lloyd, and the three sharded searchers on a mesh
    of four shards of ``device`` (and of every card where there are two or
    more)."""
    from pqvector_tpu_torch import dist

    t_phase = time.perf_counter()
    out = {}
    meshes = {n: dist.make_mesh(n, device=device) for n in (1, N_SHARDS)}
    _build.reset_launches()
    phase10_build(torch, pqt, _build, ds, dist, emb_np, queries, truth[1].cpu().numpy(),
                  index, r8, meshes, out)
    torch.cuda.empty_cache()
    phase10_serve(torch, pqt, _build, ds, dist, emb_np, queries, q, truth, index, chosen,
                  meshes, out)
    torch.cuda.empty_cache()
    out["launches"] = {k_: v for k_, v in _build.LAUNCHES.items() if v}
    if meshes[1].devices[0].type == "cuda":
        for name in ("K1", "K2", "K3", "K7", "K8"):
            check(out["launches"].get(name, 0) > 0, f"{name} was not launched in phase 10")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 10 launches {out['launches']}; {out['seconds']:.1f} s on {card}")
    return out


BIG_BATCH = 4096  # phase 11's second batch: the packed-key scans' chunked branch


def expect_launches(n, want, dev, what):
    """``want`` launches on the card; on the CPU (a rehearsal) the plain
    versions launch nothing."""
    want = want if dev.type == "cuda" else 0
    check(n == want, f"{what}: {n} launches, not {want}")


def exact_distances_hold(emb_np, queries, d, ids, what):
    """Every slot of (sqrt distances, ids, numpy) is a row at its exact
    distance from its query, within f32 rounding of a 128-term sum.
    -> the largest error."""
    d, ids = np.asarray(d, np.float64), np.asarray(ids)
    check(bool((ids >= 0).all() and np.isfinite(d).all()), f"{what}: empty slots")
    diff = emb_np[ids].astype(np.float64) - queries[:, None, :].astype(np.float64)
    want = np.sqrt((diff * diff).sum(-1))
    err = np.abs(d - want)
    check(bool((err <= 1e-5 * want + 1e-5).all()),
          f"{what}: a distance is off its row's exact distance by {err.max():.3g}")
    return float(err.max())


def phase11_scans(torch, ds, tdev, fo, q, queries, q_big, big, emb_np, truth_np, out):
    """(a) ``exact`` with xbin, xbin8 and tilescan on the file-order bf16
    searcher at B = 256 (recall, exact distances, ms beside K7 and the
    mm + row-min floor), then xbin and tilescan at B = 4096 through their
    chunked branch (exact distances; on the first 256 queries the B = 256
    recall within 0.005: a bigger batch may sum the f32 products in another
    order, which moves keys at near ties)."""
    n_pad = int(fo.emb.shape[0])
    qb = q.to(torch.bfloat16)
    sq = fo._pallas_emb_sq()
    out["floor_ms"] = time_ms(lambda: (sq[None, :] - 2.0 * (qb @ fo.emb.T).float()).amin(1))
    out["binscan_ms"] = time_ms(lambda: fo.exact(q, K, "binscan"))
    out["binscan_recall"] = recall_of(ds, truth_np, fo.exact(q, K, "binscan")[1])
    res256 = {}
    for mode in ("xbin", "xbin8", "tilescan"):
        d, ids = fo.exact(q, K, mode)
        res256[mode] = (d, ids)
        r = recall_of(ds, truth_np, ids)
        err = exact_distances_hold(emb_np, queries, d.cpu().numpy(), ids.cpu().numpy(),
                                   f"exact({mode}) B={BATCH}")
        out[mode] = {"recall_at_10": r, "max_abs_err": err,
                     "ms": time_ms(lambda: fo.exact(q, K, mode))}
        log(f"phase 11 exact({mode}) bf16 file order B={BATCH}: recall@{K} {r:.4f}, "
            f"distances exact (max err {err:.3g}), {out[mode]['ms']:.3f} ms/batch")
    lb = fo._xbin_bins_checked(K)
    tile = fo._tilescan_tile_checked(K)
    out["geometry"] = {"xbin_bins": lb, "tilescan_tile": tile, "n_pad": n_pad}
    log(f"phase 11 B={BATCH}: K7 binscan {out['binscan_ms']:.3f} ms (recall@{K} "
        f"{out['binscan_recall']:.4f}), bf16 mm + row min floor {out['floor_ms']:.3f} ms; "
        f"xbin {lb} bins, tilescan tile {tile}")
    groups = tdev._xbin_auto_chunk(big, n_pad, lb, fo.xbin_chunk_groups)
    steps = {"xbin": len(tdev._group_steps(n_pad // lb, lb, groups)),
             "tilescan": len(tdev._tilescan_steps(big, n_pad, tile, fo.tilescan_chunk_rows))}
    for mode in ("xbin", "tilescan"):
        check(steps[mode] > 1, f"exact({mode}) B={big} took one step, not the chunked branch")
        d, ids = fo.exact(q_big, K, mode)
        err = exact_distances_hold(emb_np, q_big.cpu().numpy(), d.cpu().numpy(),
                                   ids.cpu().numpy(), f"exact({mode}) B={big}")
        r = recall_of(ds, truth_np, ids[:BATCH])
        check(abs(r - out[mode]["recall_at_10"]) <= 0.005,
              f"exact({mode}) B={big}: recall@{K} {r:.4f} on the first {BATCH} queries, "
              f"{out[mode]['recall_at_10']:.4f} at B={BATCH}")
        same = int((ids[:BATCH] == res256[mode][1]).sum())
        ms = time_ms(lambda: fo.exact(q_big, K, mode), reps=3)
        out[f"{mode}_b{big}"] = {"steps": steps[mode], "max_abs_err": err, "ms": ms,
                                 "recall_first_256": r, "ids_equal_b256": same}
        log(f"phase 11 exact({mode}) B={big}: {steps[mode]} steps (the chunked branch), "
            f"distances exact, first {BATCH} queries recall@{K} {r:.4f} ({same} of "
            f"{BATCH * K} ids as at B={BATCH}), {ms:.3f} ms/batch")
    out[f"floor_ms_b{big}"] = time_ms(
        lambda: (sq[None, :] - 2.0 * (q_big.to(torch.bfloat16) @ fo.emb.T).float()).amin(1),
        reps=3)
    out[f"binscan_ms_b{big}"] = time_ms(lambda: fo.exact(q_big, K, "binscan"), reps=3)
    log(f"phase 11 B={big}: K7 binscan {out[f'binscan_ms_b{big}']:.3f} ms, floor "
        f"{out[f'floor_ms_b{big}']:.3f} ms")


def phase11_autoscan(torch, _build, fo, q, out):
    """(b) ``autoscan``: the default prober's report on the card and its
    route, then an injected healthy and degraded report, each route giving
    ``search(scan)``'s and ``search(binscan)``'s ids; K7 launches on the
    degraded route only."""
    from pqvector_tpu_torch.query.autotune import WeatherReport

    t0 = time.perf_counter()
    route = fo.scan_route(q, K, force=True)
    rep = fo._weather[1]
    out["weather"] = {"floor_qps": rep.floor_qps, "extract_qps": rep.extract_qps,
                      "extract_frac": rep.extract_frac, "degraded": rep.degraded,
                      "route": route, "probe_s": time.perf_counter() - t0}
    log(f"phase 11 probe_weather on {q.device}: floor {rep.floor_qps:.0f} QPS, extraction "
        f"{rep.extract_qps:.0f} QPS, extract_frac {rep.extract_frac:.4f} -> "
        f"{'degraded' if rep.degraded else 'healthy'}, route {route} "
        f"({out['weather']['probe_s']:.1f} s)")
    for degraded, mode in ((False, "scan"), (True, "binscan")):
        fo.weather_prober = lambda s, qq, k, budget_s=1.0, dg=degraded: WeatherReport(
            floor_qps=1.0, extract_qps=0.1 if dg else 0.6, extract_frac=0.1 if dg else 0.6,
            degraded=dg, batch=len(qq), k=k)
        fo._weather = None
        (d, ids), k7 = launched(_build, "K7", lambda: fo.search(q, K, 1, "autoscan"))
        check(torch.equal(ids, fo.search(q, K, 1, mode)[1]),
              f"autoscan ({'degraded' if degraded else 'healthy'}) differs from search({mode})")
        expect_launches(k7, int(degraded), q.device, f"autoscan {mode} route, K7")
        out[f"autoscan_{mode}"] = {"K7_launches": k7}
    fo.weather_prober = None
    fo._weather = None
    for mode in ("scan", "binscan"):
        out[f"autoscan_{mode}"]["ms"] = time_ms(lambda: fo.search(q, K, 1, mode))
    log("phase 11 autoscan: a healthy report routes to scan (no K7 launch), a degraded "
        "one to binscan (K7 launched); each gives that mode's ids; search(scan) "
        f"{out['autoscan_scan']['ms']:.3f} ms/batch, search(binscan) "
        f"{out['autoscan_binscan']['ms']:.3f}")


def phase11_loops(torch, ds, _build, tdev, fo, sorted16, q, truth_np, chosen, out):
    """(c) The loops under ``loop_rescore`` "body" and "defer", reps 4: the
    deferred result is the storage-precision selection of 2k re-scored once
    against the f32 copy, exactly."""
    from pqvector_tpu_torch.kernels.scan_topk import _refine

    qc = fo._check_queries(q)
    out["hbm_bytes"] = fo._hbm_bytes()
    out["auto_defers"] = fo._loop_defer_rescore()
    cases = (("search_loop", "binscan8", fo, "K7"), ("exact_loop", "xbin8", fo, None),
             ("search_loop", "stream", sorted16, "K3"))
    for loop, mode, s, kern in cases:
        res = {}
        for form in ("body", "defer"):
            s.loop_rescore = form
            call = (lambda: s.search_loop(q, K, chosen, reps=4, mode=mode)) \
                if loop == "search_loop" else (lambda: s.exact_loop(q, K, reps=4, mode=mode))
            if kern is None:
                d, ids = call()
            else:
                (d, ids), n = launched(_build, kern, call)
                expect_launches(n, 4, q.device, f"{loop}({mode}) {form}, {kern}")
            res[form] = {"recall_at_10": recall_of(ds, truth_np, ids),
                         "ms": time_ms(call, reps=3)}
        s.loop_rescore = "auto"

        def one_rescore():
            s._hold_ref = True
            try:
                if loop == "search_loop":
                    d2, i2 = s._search_raw(qc, 2 * K, chosen, mode)
                else:
                    d2, i2 = s._exact_raw(qc, 2 * K, mode)
            finally:
                s._hold_ref = False
            d2, i2 = _refine(qc, s._emb_ref, d2, i2, K)
            return d2.sqrt(), s._map_ids(d2, i2)

        want = uncounted(_build, one_rescore)
        check(torch.equal(ids, want[1]) and torch.equal(d, want[0]),
              f"{loop}({mode}) defer is not the 2k selection re-scored once")
        out[f"{loop}_{mode}"] = res
        log(f"phase 11 {loop}({mode}) reps 4: body recall@{K} "
            f"{res['body']['recall_at_10']:.4f} {res['body']['ms']:.3f} ms, defer "
            f"{res['defer']['recall_at_10']:.4f} {res['defer']['ms']:.3f} ms; defer = the "
            "2k storage-precision selection re-scored once")
    log(f"phase 11 _hbm_bytes() {out['hbm_bytes']} ({out['hbm_bytes'] / 2**30:.1f} GiB): "
        f"loop_rescore='auto' {'defers' if out['auto_defers'] else 're-scores in the body'} "
        f"at {fo.emb.shape[0]} x {fo.emb.shape[1]} bf16 + f32 copy")


def phase11(torch, pqt, _build, ds, path, emb_np, queries, q, truth, index, chosen, card,
            device="cuda:0"):
    """Slice 11's path on the phase-3 file in its original row order (bf16
    storage with the f32 copy), launch counts from 0: the packed-key scans,
    the weather-routed autoscan, the loops' deferred re-score, and the
    sharded packed-key scans on four shards of ``device``."""
    import pqvector_tpu_torch.query.device as tdev
    from pqvector_tpu_torch import dist

    t_phase = time.perf_counter()
    out = {}
    dev = torch.device(device)
    truth_np = truth[1].cpu().numpy()
    fo = pqt.DeviceIvfSearcher.from_parquet(path, dtype=torch.bfloat16, row_tile=ROW_TILE,
                                            device=dev)
    check(not fo._row_cluster_sorted, "from_parquet did not keep the file order")
    sorted16 = pqt.DeviceIvfSearcher(index, emb_np, dtype=torch.bfloat16, row_tile=ROW_TILE,
                                     cluster_sorted=True, device=dev)
    rng = np.random.default_rng(11)
    more = emb_np[rng.integers(0, ROWS, BIG_BATCH - BATCH)] + 0.05 * rng.standard_normal(
        (BIG_BATCH - BATCH, DIM)).astype(np.float32)
    q_big = torch.from_numpy(np.concatenate([queries, more])).to(dev)
    _build.reset_launches()
    phase11_scans(torch, ds, tdev, fo, q, queries, q_big, BIG_BATCH, emb_np, truth_np, out)
    torch.cuda.empty_cache()
    phase11_autoscan(torch, _build, fo, q, out)
    phase11_loops(torch, ds, _build, tdev, fo, sorted16, q, truth_np, chosen, out)
    del sorted16, q_big
    torch.cuda.empty_cache()

    s4 = dist.DistributedIvfSearcher(index, emb_np, mesh=dist.make_mesh(N_SHARDS, device=dev),
                                     dtype=torch.bfloat16)
    check(s4.can_xbin(K), "the sharded searcher cannot take xbin")
    for name, fn in (("xbin", lambda: s4.search_xbin(queries, K)),
                     ("xbin8", lambda: s4.search_xbin8(queries, K))):
        d, ids = fn()
        err = exact_distances_hold(emb_np, queries, d, ids, f"search_{name} x {N_SHARDS}")
        out[f"dist_{name}"] = {"recall_at_10": recall_of(ds, truth_np, ids),
                               "max_abs_err": err, "ms": time_ms(fn, reps=3)}
        log(f"phase 11 search_{name} on {N_SHARDS} shards of one card: recall@{K} "
            f"{out[f'dist_{name}']['recall_at_10']:.4f}, distances exact, "
            f"{out[f'dist_{name}']['ms']:.3f} ms/batch")
    del s4, fo
    torch.cuda.empty_cache()
    out["launches"] = {k_: v for k_, v in _build.LAUNCHES.items() if v}
    if dev.type == "cuda":
        for name in ("K3", "K7"):
            check(out["launches"].get(name, 0) > 0, f"{name} was not launched in phase 11")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 11 launches {out['launches']}; {out['seconds']:.1f} s on {card}")
    return out


def write_rows(ds, data_dir):
    """Phase 3's rows: the seeded 1M x 128 file written as Parquet under
    ``data_dir`` (made anew) and read back, and the 256 seeded queries.
    -> (path, rows, queries)."""
    from pqvector_tpu_torch.io.reader import read_embedding_column

    shutil.rmtree(data_dir, ignore_errors=True)
    os.makedirs(data_dir)
    path = os.path.join(data_dir, f"bench_{ROWS}x{DIM}.parquet")
    t0 = time.perf_counter()
    ds.generate_dataset(path, ROWS, DIM)
    log(f"setup: wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB) "
        f"in {time.perf_counter() - t0:.1f} s")
    emb_np = read_embedding_column(path, "embedding").data
    rng = np.random.default_rng(7)  # queries as bench.py:573-577
    queries = emb_np[rng.integers(0, ROWS, BATCH)] + 0.05 * rng.standard_normal(
        (BATCH, DIM)
    ).astype(np.float32)
    return path, emb_np, queries


def phase3_serve(torch, pqt, _build, ds, index, emb, q, dev):
    """Phase 3's truth and probe sweep on ``index`` over the rows ``emb``:
    the f32 exact truth (auto), then the sorted bf16 searcher's
    ``search(auto)`` (K4) at nprobe 1, 2, 4, ... until recall@10 reaches
    the target, and ``search(stream)`` (K3) with the same ids there.
    -> (truth searcher, (truth d, truth ids), bf16 searcher, nprobe, recall)."""
    truth_s = pqt.DeviceIvfSearcher(index, emb, row_tile=ROW_TILE,
                                    cluster_sorted=True, device=dev)
    t0 = time.perf_counter()
    truth_d, truth_ids = truth_s.exact(q, K)
    torch.cuda.synchronize()
    log(f"phase 3 exact truth (auto, f32, B={BATCH}): {time.perf_counter() - t0:.3f} s")
    truth_np = truth_ids.cpu().numpy()
    check(bool(torch.isfinite(truth_d).all()) and truth_np.shape == (BATCH, K),
          "exact truth has empty slots")
    searcher = pqt.DeviceIvfSearcher(index, emb, dtype=torch.bfloat16,
                                     row_tile=ROW_TILE, cluster_sorted=True,
                                     device=dev)
    chosen, recall = None, 0.0
    nprobe = 1
    while nprobe <= N_CLUSTERS:
        before = _build.LAUNCHES["K4"]
        d, ids = searcher.search(q, K, nprobe, "auto")
        check(_build.LAUNCHES["K4"] == before + 1, "search(auto) did not take K4")
        recall = ds.recall_at_k(truth_np, ids.cpu().numpy())
        log(f"phase 3 search auto (K4) nprobe={nprobe}: recall@{K} {recall:.4f}")
        if recall >= RECALL_TARGET:
            chosen = nprobe
            break
        nprobe *= 2
    check(chosen is not None, f"recall never reached {RECALL_TARGET}")
    check(bool(torch.isfinite(d).all()), "search returned empty slots")
    d_s, ids_s = searcher.search(q, K, chosen, "stream")
    check(torch.equal(ids_s, ids), "K3 (stream) and K4 (auto) ids differ")
    log(f"phase 3 K3 (stream) and K4 (auto) ids identical at nprobe={chosen}")
    return truth_s, (truth_d, truth_ids), searcher, chosen, recall


def _walk_plan(plan):
    yield plan
    for child in plan.children():
        yield from _walk_plan(child)


def main() -> None:
    t_script = time.perf_counter()
    sys.path.insert(0, ROOT)
    try:
        import torch

        import pqvector_tpu_torch as pqt
        from pqvector_tpu_torch import datasets as ds
        from pqvector_tpu_torch.kernels import _build
    except ImportError as exc:
        fail(f"the port is not importable here: {exc}")
    global _BUILD
    _BUILD = _build

    # ---- phase 1 ---------------------------------------------------------
    check(torch.cuda.is_available(), "no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    check(cap == (9, 0), f"need a Hopper card (capability 9.0), got {cap}")
    card = card_line()
    log(f"phase 1 card: {card}")
    log(f"phase 1 torch {torch.__version__} (CUDA {torch.version.cuda})")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    log("phase 1 nvcc: " + nvcc.stdout.strip().splitlines()[-1])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.load()
    log(f"phase 1 kernels built and loaded in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds:.2f} s)")

    from pqvector_tpu_torch.io.embed import read_index_from_parquet
    from pqvector_tpu_torch.io.reader import read_embedding_column
    from pqvector_tpu_torch.kernels import assign as ka
    from pqvector_tpu_torch.kernels import binscan as bs
    from pqvector_tpu_torch.kernels import compact as cp
    from pqvector_tpu_torch.kernels import scan_topk as sc
    from pqvector_tpu_torch.kernels import stream_topk as st
    from pqvector_tpu_torch.kernels import tilemin as tm
    from pqvector_tpu_torch.query.device import _compact_select, _quantize_rows_i8
    from pqvector_tpu_torch.types import Embeddings

    dev = torch.device(DEVICE)
    data_dir = os.path.join(ROOT, "data", "chip_smoke")
    path, emb_np, queries = write_rows(ds, data_dir)

    # ---- phase 2 ---------------------------------------------------------
    phase2_small(torch, st, sc, ka)
    phase2_small_slice2(torch, st, sc, bs, _quantize_rows_i8)
    phase2_small_k9(torch, tm)
    phase2_score_tile(torch, tm, sc)
    phase2_small_k1_k2(torch, ka, st)
    phase2_masked_score_tile(torch, st, sc)
    phase2_k6_score_tile(torch, st, sc)
    phase2_binscan_score_tile(torch, bs, _quantize_rows_i8)
    phase2_small_gather(torch, cp)
    results: dict[str, dict] = {}
    t0 = time.perf_counter()
    config = pqt.IvfBuildConfig(n_clusters=N_CLUSTERS)
    index_a = pqt.build_ivf_index(Embeddings(emb_np, DIM), config, device=dev)
    torch.cuda.synchronize()
    log(f"phase 2b reference build on the card: {time.perf_counter() - t0:.2f} s")
    xt = torch.from_numpy(emb_np).to(dev)
    ct = torch.from_numpy(index_a.centroids).to(dev)
    got, want = ka.assign_rows(xt, ct), ka.assign_rows_plain(xt, ct)
    diff = torch.nonzero(got != want).flatten().cpu().numpy()
    c64 = index_a.centroids.astype(np.float64)
    cn = (c64 * c64).sum(1)
    g_np, w_np = got.cpu().numpy(), want.cpu().numpy()
    k1_err = 0.0
    for r in diff:
        xr = emb_np[r].astype(np.float64)
        sg = cn[g_np[r]] - 2 * xr @ c64[g_np[r]]
        sw = cn[w_np[r]] - 2 * xr @ c64[w_np[r]]
        k1_err = max(k1_err, abs(sg - sw))
        check(abs(sg - sw) <= 1e-5 * (xr @ xr + cn.max()), f"K1 row {r}: no tie")
    results["K1"] = {
        "max_abs_err": k1_err,
        "ms": time_ms(lambda: ka.assign_rows(xt, ct)),
        "plain_ms": time_ms(lambda: ka.assign_rows_plain(xt, ct)),
    }
    log(f"phase 2b K1 1M x 128, k=1024: {diff.size} near-tie rows differ; "
        f"kernel {results['K1']['ms']:.3f} ms, plain {results['K1']['plain_ms']:.3f} ms")
    cn32 = (ct * ct).sum(1)
    results["K1"].update(
        bound_of(nbytes_of(xt, ct) + ROWS * 4, 2.0 * ROWS * N_CLUSTERS * DIM, "fp32"),
        library_ms=time_ms(lambda: torch.argmin(cn32[None, :] - 2.0 * (xt @ ct.T), dim=1),
                           reps=5),
    )
    log(f"phase 2b K1: bound {results['K1']['bound_ms']:.3f} ms "
        f"({results['K1']['bound_by']}), mm + argmin {results['K1']['library_ms']:.3f} ms")
    del xt, got, want, cn32

    s32 = pqt.DeviceIvfSearcher(index_a, emb_np, row_tile=ROW_TILE,
                                cluster_sorted=True, device=dev)
    s16 = pqt.DeviceIvfSearcher(index_a, emb_np, dtype=torch.bfloat16,
                                row_tile=ROW_TILE, cluster_sorted=True, device=dev)
    tile = s32._scan_tile()
    q = torch.from_numpy(queries).to(dev)
    x32, sq32 = stored_f64(s32.emb), s32._pallas_emb_sq().cpu().numpy().astype(np.float64)
    q32 = queries.astype(np.float64)
    results["K2"] = k2_timed(torch, st, q, s32.emb, s32._pallas_emb_sq(), K, tile, "fp32",
                             (q32, x32, sq32))
    results["K2"].update({f"k100_{key}": v for key, v in k2_timed(
        torch, st, q, s32.emb, s32._pallas_emb_sq(), 100, tile, "fp32",
        (q32, x32, sq32)).items()})
    e_args = (q, s32.emb, s32._pallas_emb_sq(), K, tile)
    err, swaps = compare_topk(sc._final_merge(*sc.exact_scan(*e_args), K),
                              sc._final_merge(*sc.exact_scan_plain(*e_args), K),
                              q32, x32, sq32)
    results["K5"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: sc.exact_scan(*e_args)),
        "plain_ms": time_ms(lambda: sc.exact_scan_plain(*e_args)),
    }
    log(f"phase 2b K5 f32 1M x 128, B={BATCH}, k={K}, tile={tile}: {swaps} near-tie "
        f"swaps after the merge, max err {err:.3g}; kernel {results['K5']['ms']:.3f} ms, "
        f"plain {results['K5']['plain_ms']:.3f} ms")
    n_pad = s32.emb.shape[0]
    sq_f = s32._pallas_emb_sq()
    lib_topk = results["K2"]["library_ms"]  # the same chain on the same inputs
    scan_bytes = nbytes_of(q, s32.emb, sq_f)
    results["K5"].update(bound_of(scan_bytes + (n_pad // tile) * BATCH * K * 8,
                                  2.0 * BATCH * n_pad * DIM, "fp32"), library_ms=lib_topk)
    log(f"phase 2b K5: bound {results['K5']['bound_ms']:.3f} ms "
        f"({results['K5']['bound_by']}), mm + topk {lib_topk:.3f} ms")

    nprobe_2b = 8
    lcl, tc, cmax = s16._tile_cluster_table(tile)
    qf16 = q.to(torch.bfloat16)
    mask = st._probe_mask(q, s16.centroids, s16.c_sq, nprobe_2b,
                          s16._max_probe_bucket(nprobe_2b),
                          -(-(N_CLUSTERS + 1) // 128) * 128)
    sched = st._tile_schedule(mask, tc)
    x16, sq16 = stored_f64(s16.emb), s16._pallas_emb_sq().cpu().numpy().astype(np.float64)
    q16 = stored_f64(qf16)
    masked16 = masked_timed(torch, sc, st, qf16, s16.emb, s16._pallas_emb_sq(), lcl, tc, mask,
                            sched, s16.row_cluster, K, tile, "bf16", (q16, x16, sq16),
                            f"phase 2b K3/K4 bf16 nprobe={nprobe_2b}, cmax={cmax}")
    masked32 = masked_timed(torch, sc, st, q, s32.emb, s32._pallas_emb_sq(), lcl, tc, mask,
                            sched, s32.row_cluster, K, tile, "fp32", (q32, x32, sq32),
                            f"phase 2b K3/K4 f32 nprobe={nprobe_2b}, cmax={cmax}")
    del x32
    for name in ("K3", "K4"):
        results[name] = masked16[name]
        results[name].update({f"f32_{key}": v for key, v in masked32[name].items()})
    masked_work = {"1M x 128 bf16": masked16["work"], "1M x 128 f32": masked32["work"]}
    b_args = (qf16, s16.emb, s16._pallas_emb_sq(), K, tile)
    err, swaps = compare_topk(sc._final_merge(*sc.exact_scan(*b_args), K),
                              sc._final_merge(*sc.exact_scan_plain(*b_args), K),
                              q16, x16, sq16)
    sq_h = s16._pallas_emb_sq()
    res16 = {
        "max_abs_err": err,
        "ms": time_ms(lambda: sc.exact_scan(*b_args)),
        "plain_ms": time_ms(lambda: sc.exact_scan_plain(*b_args)),
        "library_ms": time_ms(lambda: torch.topk(
            sq_h[None, :] - 2.0 * (qf16 @ s16.emb.T).float(), K, dim=1, largest=False)),
    }
    res16.update(bound_of(nbytes_of(qf16, s16.emb, sq_h) + (n_pad // tile) * BATCH * K * 8,
                          2.0 * BATCH * n_pad * DIM, "bf16"))
    results["K5"].update({f"bf16_{key}": v for key, v in res16.items()})
    log(f"phase 2b K5 bf16 (wgmma) 1M x 128, B={BATCH}, k={K}, tile={tile}: {swaps} "
        f"near-tie swaps after the merge, max err {err:.3g}; kernel {res16['ms']:.3f} ms, "
        f"plain {res16['plain_ms']:.3f} ms, bf16 mm + topk {res16['library_ms']:.3f} ms, "
        f"bound {res16['bound_ms']:.3f} ms ({res16['bound_by']})")
    for kk, label in ((K, "bf16"), (100, "bf16_k100")):
        results["K2"].update({f"{label}_{key}": v for key, v in k2_timed(
            torch, st, qf16, s16.emb, s16._pallas_emb_sq(), kk, tile, "bf16",
            (q16, x16, sq16)).items()})
    phase2b_slice2(torch, pqt, sc, st, bs, _compact_select, index_a, emb_np, s16, q,
                   q16, tile, results)
    phase2b_slice3(torch, tm, cp, _compact_select, s32, s16, q, results)
    del s32, s16, x16
    torch.cuda.empty_cache()

    # ---- phase 3: the main path -----------------------------------------
    from pqvector_tpu_torch.utils.profiling import drain_stages

    _build.reset_launches()
    drain_stages()
    t0 = time.perf_counter()
    index = pqt.IndexBuilder(path, "embedding", device=dev).n_clusters(N_CLUSTERS).build_inplace()
    build_s = time.perf_counter() - t0
    build_stages = dict(drain_stages())
    log(f"phase 3 build_inplace 1M x 128, IVF-{N_CLUSTERS} on the card: {build_s:.2f} s; "
        "stages " + ", ".join(f"{k_} {v:.3f} s" for k_, v in build_stages.items()))
    check(pqt.has_pq_vector_index(path), "has_pq_vector_index is false")
    import pyarrow.parquet as pq

    check(pq.read_table(path).num_rows == ROWS, "pyarrow no longer reads the file")
    index_r, column = read_index_from_parquet(path)
    check(index_r.to_bytes() == index.to_bytes(), "index read back differs")
    check(index.to_bytes() == index_a.to_bytes(),
          "two builds with one seed gave different index bytes")
    log("phase 3 index in the footer, file readable by pyarrow; two builds "
        "with seed 42 gave identical index bytes, SHA-256 "
        + hashlib.sha256(index.to_bytes()).hexdigest()[:16])
    emb = read_embedding_column(path, column).data
    check(np.array_equal(emb, emb_np), "embedding column changed")

    truth_s, (truth_d, truth_ids), searcher, chosen, recall = phase3_serve(
        torch, pqt, _build, ds, index_r, emb, q, dev)
    truth_np = truth_ids.cpu().numpy()

    d100, i100 = truth_s.exact(q, 100, "stream")
    p100, pi100 = truth_s.exact(q, 100, "xla")
    gd, wd = d100.double().cpu().numpy() ** 2, p100.double().cpu().numpy() ** 2
    g_id, w_id = i100.cpu().numpy(), pi100.cpu().numpy()
    tol = 1e-5 * ((q32 * q32).sum(1) + float(sq32[sq32 < 1e38].max()))
    check(bool((np.abs(gd - wd) <= tol[:, None]).all()), "exact k=100: d2 differ")
    swaps = np.nonzero(g_id != w_id)
    for b, j in zip(*swaps):
        # a swap is allowed only between rows whose refined d2 tie
        check(abs(gd[b, j] - wd[b, j]) <= tol[b], "exact k=100: ids are no tie")
    log(f"phase 3 exact k=100 through K2 vs the plain scan: {len(swaps[0])} "
        f"near-tie swaps, max |d2| err {np.abs(gd - wd).max():.3g}")

    search_ms = time_ms(lambda: searcher.search(q, K, chosen, "auto"))
    qps = BATCH / (search_ms / 1000.0)
    stream_ms = time_ms(lambda: searcher.search(q, K, chosen, "stream"))
    log(f"phase 3 search B={BATCH} nprobe={chosen}: auto (K4) {search_ms:.3f} ms/batch, "
        f"{qps:.0f} QPS; stream (K3) {stream_ms:.3f} ms/batch on {card}")
    launches = dict(_build.LAUNCHES)

    # ---- phase 4 ---------------------------------------------------------
    for name in ("K1", "K2", "K3", "K4"):
        check(launches[name] > 0, f"{name} was not launched on the main path")
    log(f"phase 4 launches on the main path: {launches}")

    # ---- phases 5 and 6 ----------------------------------------------------
    main5 = phase5(torch, pqt, _build, ds, path, q, queries, truth_np,
                   searcher, chosen, card)
    for name in ("K5", "K6", "K7", "K8"):
        launches[name] = main5["launches"][name]
    main7 = phase7(torch, ds, truth_s, searcher, q, (truth_d, truth_ids), chosen,
                   card)
    for name in ("K9", "K10"):
        launches[name] = main7["launches"][name]
    r8 = recall_of(ds, truth_np, searcher.search(q, K, 8, "auto")[1])
    main9 = phase9(torch, pqt, _build, ds, path, emb_np, queries, q, (truth_d, truth_ids),
                   truth_s, searcher, chosen, index, build_stages, data_dir, card)
    del truth_s, searcher
    torch.cuda.empty_cache()
    main10 = phase10(torch, pqt, _build, ds, emb_np, queries, q, (truth_d, truth_ids),
                     index, r8, chosen, card)
    torch.cuda.empty_cache()
    main11 = phase11(torch, pqt, _build, ds, path, emb_np, queries, q, (truth_d, truth_ids),
                     index, chosen, card)
    main6 = phase6(torch, pqt, _build, ds, Embeddings, dev, cp, _compact_select, tm, sc, st,
                   ka)
    launches["K11"] = main6["slice3"]["gather"]["K11"]["path_launches"]
    torch.cuda.empty_cache()
    main8 = phase8(torch, pqt, _build, ds, emb_np, queries, truth_np, index.to_bytes(),
                   data_dir, card)

    kernels = []
    for name, (fn, source, replaces) in KERNELS.items():
        kernels.append({
            "name": f"{name} {fn}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            **{key: results[name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
            **{key: v for key, v in results[name].items()
               if key.startswith(("bf16_", "k100_", "f32_", "int8_"))},
            "phase9_launches": main9["launches"].get(name, 0),
            "phase10_launches": main10["launches"].get(name, 0),
            "phase11_launches": main11["launches"].get(name, 0),
        })
    log("main path: " + json.dumps({"build_s": build_s, "nprobe": chosen,
                                    "recall_at_10": recall, "search_ms": search_ms,
                                    "qps": qps, "stream_ms": stream_ms}))
    log("slice 2 path: " + json.dumps(main5))
    log("slice 3 path: " + json.dumps(main7))
    log("deep rung: " + json.dumps(main6))
    masked_work.update(main6["masked"]["work"])
    masked_work[f"K6 1M x {DIM} bf16, file order"] = results["K6"].pop("scored")
    log("K4/K3/K6 tiles and chunks scored of those a full walk scores: "
        + json.dumps(masked_work))
    log("front doors: " + json.dumps(main8))
    log("slice 9 path: " + json.dumps(main9))
    log("slice 10 path: " + json.dumps(main10))
    log("slice 11 path: " + json.dumps(main11))
    log(f"chip_smoke.py: {time.perf_counter() - t_script:.1f} s, phase 10 "
        f"{main10['seconds']:.1f} s, phase 11 {main11['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    shutil.rmtree(data_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
