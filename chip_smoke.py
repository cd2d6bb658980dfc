"""End-to-end smoke of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a Hopper GPU, the CUDA
toolkit (nvcc) and pyarrow. It imports nothing of JAX or of the JAX
package. Phases, in order; any failure exits non-zero and prints no result:

1. Environment: the card, torch, nvcc; TF32 off; build the kernels
   (``csrc/*.cu``, compiled at first use) and time the build.
2. Each kernel (K1 assign, K2 stream exact, K3 stream masked, K4 masked
   local) against its plain torch version on the card: small awkward shapes
   (ties, pad rows, fewer rows than k, k = 1 and 128, f32 and bf16) must
   agree exactly; at the main path's shapes the ids must agree except where
   the two picks tie within the f32 tolerance, and both are timed with CUDA
   events (median of 10).
3. The main path at the bench's default configuration: a seeded 1M x 128
   Parquet file, ``IndexBuilder(...).n_clusters(1024).build_inplace()`` on
   the card, exact truth from K2 on an f32 searcher, and an nprobe sweep of
   IVF ``search`` (K4) on a bf16 searcher with an f32 re-score copy until
   recall@10 >= 0.95; K3 must return K4's ids; exact k = 100 through K2
   must match the plain scan; search QPS at B = 256.
4. Coverage: every kernel was launched during phase 3.

The last lines are the kernels' JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
}


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


def grid_layout(n, d, kc, tile, seed):
    """Rows on a 1/4 grid sorted by cluster, so every score is exact in f32
    and bf16 and many distances tie; pad rows carry +3e38."""
    rng = np.random.default_rng(seed)
    cent = rng.integers(-8, 9, (kc, d)).astype(np.float32) / 4
    lab = np.sort(rng.integers(0, kc, n))
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
    q = x[rng.integers(0, n, 37)] + rng.integers(-1, 2, (37, d)).astype(np.float32) / 4
    return cent, emb, sq, lcl.reshape(-1), tc, q


def phase2_small(torch, st, sc, ka):
    dev = torch.device("cuda")
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


# --------------------------------------------------------------------------


def main() -> None:
    sys.path.insert(0, ROOT)
    try:
        import torch

        import pqvector_tpu_torch as pqt
        from pqvector_tpu_torch.kernels import _build
    except ImportError as exc:
        fail(f"the port is not importable here: {exc}")
    import bench  # numpy-only at import; its dataset and recall helpers

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
    from pqvector_tpu_torch.kernels import scan_topk as sc
    from pqvector_tpu_torch.kernels import stream_topk as st
    from pqvector_tpu_torch.types import Embeddings

    dev = torch.device("cuda")
    data_dir = os.path.join(ROOT, "data", "chip_smoke")
    shutil.rmtree(data_dir, ignore_errors=True)
    os.makedirs(data_dir)
    path = os.path.join(data_dir, f"bench_{ROWS}x{DIM}.parquet")
    t0 = time.perf_counter()
    bench.generate_dataset(path, ROWS, DIM)
    log(f"setup: wrote {path} ({os.path.getsize(path) / 1e6:.1f} MB) "
        f"in {time.perf_counter() - t0:.1f} s")
    emb_np = read_embedding_column(path, "embedding").data
    rng = np.random.default_rng(7)  # queries as bench.py:573-577
    queries = emb_np[rng.integers(0, ROWS, BATCH)] + 0.05 * rng.standard_normal(
        (BATCH, DIM)
    ).astype(np.float32)

    # ---- phase 2 ---------------------------------------------------------
    phase2_small(torch, st, sc, ka)
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
    del xt, got, want

    s32 = pqt.DeviceIvfSearcher(index_a, emb_np, row_tile=ROW_TILE,
                                cluster_sorted=True, device=dev)
    s16 = pqt.DeviceIvfSearcher(index_a, emb_np, dtype=torch.bfloat16,
                                row_tile=ROW_TILE, cluster_sorted=True, device=dev)
    tile = s32._scan_tile()
    q = torch.from_numpy(queries).to(dev)
    x32, sq32 = stored_f64(s32.emb), s32._pallas_emb_sq().cpu().numpy().astype(np.float64)
    q32 = queries.astype(np.float64)
    args = (q, s32.emb, s32._pallas_emb_sq(), K)
    err, swaps = compare_topk(st.stream_exact_scan(*args, tile),
                              st.stream_exact_scan_plain(*args), q32, x32, sq32)
    results["K2"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: st.stream_exact_scan(*args, tile)),
        "plain_ms": time_ms(lambda: st.stream_exact_scan_plain(*args)),
    }
    log(f"phase 2b K2 f32 1M x 128, B={BATCH}, k={K}, tile={tile}: {swaps} near-tie "
        f"swaps, max err {err:.3g}; kernel {results['K2']['ms']:.3f} ms, "
        f"plain {results['K2']['plain_ms']:.3f} ms")
    del x32

    nprobe_2b = 8
    lcl, tc, cmax = s16._tile_cluster_table(tile)
    qf16 = q.to(torch.bfloat16)
    mask = st._probe_mask(q, s16.centroids, s16.c_sq, nprobe_2b,
                          s16._max_probe_bucket(nprobe_2b),
                          -(-(N_CLUSTERS + 1) // 128) * 128)
    sched = st._tile_schedule(mask, tc)
    lmask = mask[:, tc.long()].permute(1, 0, 2).contiguous()
    x16, sq16 = stored_f64(s16.emb), s16._pallas_emb_sq().cpu().numpy().astype(np.float64)
    q16 = stored_f64(qf16)
    m_args = (qf16, s16.emb, s16._pallas_emb_sq(), lcl, tc, mask, sched, K, tile)
    err, swaps = compare_topk(st.stream_masked_scan(*m_args),
                              st.stream_masked_scan_plain(*m_args), q16, x16, sq16)
    results["K3"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: st.stream_masked_scan(*m_args)),
        "plain_ms": time_ms(lambda: st.stream_masked_scan_plain(*m_args)),
    }
    log(f"phase 2b K3 bf16 nprobe={nprobe_2b}: {swaps} near-tie swaps, max err "
        f"{err:.3g}; kernel {results['K3']['ms']:.3f} ms, plain "
        f"{results['K3']['plain_ms']:.3f} ms")
    l_args = (qf16, s16.emb, s16._pallas_emb_sq(), lcl, lmask, K, tile)
    g4, w4 = sc.masked_local_scan(*l_args), sc.masked_local_scan_plain(*l_args)
    err, swaps = compare_topk(sc._final_merge(*g4, K), sc._final_merge(*w4, K),
                              q16, x16, sq16)
    results["K4"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: sc.masked_local_scan(*l_args)),
        "plain_ms": time_ms(lambda: sc.masked_local_scan_plain(*l_args)),
    }
    log(f"phase 2b K4 bf16 nprobe={nprobe_2b}, nt={lmask.shape[0]}, cmax={cmax}: "
        f"{swaps} near-tie swaps after the merge, max err {err:.3g}; kernel "
        f"{results['K4']['ms']:.3f} ms, plain {results['K4']['plain_ms']:.3f} ms")
    del s32, s16, x16, g4, w4, lmask
    torch.cuda.empty_cache()

    # ---- phase 3: the main path -----------------------------------------
    _build.reset_launches()
    t0 = time.perf_counter()
    index = pqt.IndexBuilder(path, "embedding", device=dev).n_clusters(N_CLUSTERS).build_inplace()
    build_s = time.perf_counter() - t0
    log(f"phase 3 build_inplace 1M x 128, IVF-{N_CLUSTERS} on the card: {build_s:.2f} s")
    check(pqt.has_pq_vector_index(path), "has_pq_vector_index is false")
    import pyarrow.parquet as pq

    check(pq.read_table(path).num_rows == ROWS, "pyarrow no longer reads the file")
    index_r, column = read_index_from_parquet(path)
    check(index_r.to_bytes() == index.to_bytes(), "index read back differs")
    check(index.to_bytes() == index_a.to_bytes(),
          "two builds with one seed gave different index bytes")
    log("phase 3 index in the footer, file readable by pyarrow; two builds "
        "with seed 42 gave identical index bytes")
    emb = read_embedding_column(path, column).data
    check(np.array_equal(emb, emb_np), "embedding column changed")

    truth_s = pqt.DeviceIvfSearcher(index_r, emb, row_tile=ROW_TILE,
                                    cluster_sorted=True, device=dev)
    t0 = time.perf_counter()
    truth_d, truth_ids = truth_s.exact(q, K)
    torch.cuda.synchronize()
    log(f"phase 3 exact truth (auto, f32, B={BATCH}): {time.perf_counter() - t0:.3f} s")
    truth_np = truth_ids.cpu().numpy()
    check(bool(torch.isfinite(truth_d).all()) and truth_np.shape == (BATCH, K),
          "exact truth has empty slots")
    searcher = pqt.DeviceIvfSearcher(index_r, emb, dtype=torch.bfloat16,
                                     row_tile=ROW_TILE, cluster_sorted=True,
                                     device=dev)
    chosen, recall = None, 0.0
    nprobe = 1
    while nprobe <= N_CLUSTERS:
        before = _build.LAUNCHES["K4"]
        d, ids = searcher.search(q, K, nprobe, "auto")
        check(_build.LAUNCHES["K4"] == before + 1, "search(auto) did not take K4")
        recall = bench.recall_at_k(truth_np, ids.cpu().numpy())
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
    log(f"phase 3 search B={BATCH} nprobe={chosen}: {search_ms:.3f} ms/batch, "
        f"{qps:.0f} QPS on {card}")
    launches = dict(_build.LAUNCHES)

    # ---- phase 4 ---------------------------------------------------------
    for name in KERNELS:
        check(launches[name] > 0, f"{name} was not launched on the main path")
    log(f"phase 4 launches on the main path: {launches}")

    kernels = []
    for name, (fn, source, replaces) in KERNELS.items():
        kernels.append({
            "name": f"{name} {fn}", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": results[name]["max_abs_err"],
            "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
        })
    log("main path: " + json.dumps({"build_s": build_s, "nprobe": chosen,
                                    "recall_at_10": recall, "search_ms": search_ms,
                                    "qps": qps}))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    shutil.rmtree(data_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
