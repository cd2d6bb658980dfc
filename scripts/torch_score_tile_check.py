"""Quick check and timing of the score-tile kernels (K9 tile min, K5 exact
per-tile top-k, K4 and K6 masked per-tile top-k, K2 and K3 streaming exact and
masked top-k, K1 nearest-centroid assign, K7 and K8 binned-min scan) of the
PyTorch port on one Hopper GPU.

    python3 scripts/torch_score_tile_check.py [--rows 1000000] [--no-ptxas]
        [--time-only] [--package-root DIR] [--digest-file FILE] [--modes M]
        [--sweep] [--share-sweep]

Needs a card, nvcc and the repo root as the working directory. It
1. compiles the four sources once more with ``-Xptxas -v`` and prints
   registers, spills and shared memory of the score-tile kernels;
2. holds the C sources' shared-memory sizes to ``kernels/score_tile.py``;
3. runs the kernels against their plain versions on 1/4-grid data (every
   sum exact, so the results must be equal) over awkward shapes, on both
   back ends, K2 and K3 also over several splits of the rows, K4 with its
   counters of scored tiles and chunks held to the skip rule;
4. times them at ``--rows`` x 128 (K9, K5 and K2 at B = 256 in f32 and bf16,
   K2 at k = 1, 10, 100 and 128 and at B = 1; K1 against 1024 centroids)
   beside one PyTorch chain for the same function, with CUDA events (median
   of 10), builds IVF-1024 over ``--rows`` x 128 seeded mixture rows (K1 in
   every Lloyd step) and prints a SHA-256 of K1's ids (f32 rows, and the same
   rows in bf16), of K2's f32 distances and ids and of the index bytes;
5. with ``--modes M``: times K4 and K3 on those cluster-sorted rows (tiles of
   1024 rows, the M mode centres as centroids, nprobe 8) at B = 1, 16, 64, 256
   and 4096, k = 10 and 100, in f32 and bf16, prints the share of tiles and
   chunks K4's skip rule scores and K3's work items and chunks
   (``stream_topk.scored_items``), and adds the SHA-256 of their f32 outputs to
   the digests; then K6 on the same rows stored in a seeded random order
   (file order) at the same shapes, and K7 (tile 2048, expand 2) and K8 (a
   seeded half of those tiles) at B = 1, 16, 64, 256 and 4096 in f32, bf16
   and int8 codes, each beside its bound and, up to B = 256, the PyTorch
   chain of ``chip_smoke.py`` phase 2b, adding the SHA-256 of K6's f32
   outputs and of K7's and K8's f32 and int8 key tables. The layout, the
   probe mask and ids, the local mask and the offsets come from seeded numpy and
   plain torch code in this script, so two versions of the package get the
   same tensors.

6. with ``--sweep``: K1 at 1M x d x 1000, d = 32 .. 1024, on seeded
   mixture rows and k-means centroids: K1 f32, the bf16 rows through the
   FMA form, the screen (with the share it leaves uncertified) and the
   default route, and the blocked ``mm`` + ``argmin``, beside the function's
   bound and each form's floor (this sets ``assign.SCREEN_MIN_DIM``);
7. with ``--share-sweep``: K1's bf16 rows at 1M x d x 1000, d = 64, 96,
   128, 512 and 1024, with 0, 125, 250, 375 and 500 pairs of centroids made equal
   (every row nearest to a pair ties, so the share the screen leaves
   uncertified rises to 1): the FMA form over all rows, the screen without
   its probe (then the re-score of what it leaves), the default route (with
   the probe) and the screen alone, and the share at which the first two
   cross (this sets ``assign.RESCORE_BREAK_EVEN``).

A short first call after touching the CUDA sources; ``chip_smoke.py`` is the
full run. ``--time-only`` skips steps 2 and 3. ``--package-root DIR`` takes
``pqvector_tpu_torch`` from another checkout (say, an earlier commit unpacked
with ``git archive`` under ``build/``), to time two versions of the kernels
in one call on one card; use it with ``--time-only --no-ptxas``.
``--modes M`` draws the rows from M Gaussian modes and stores them mode by
mode, as a cluster-sorted searcher holds them (the default, 0, is one
standard normal cloud in random order): near rows then arrive in bursts and
the top-k lists take more replacements.
``--digest-file FILE`` holds the digests to the ones FILE has under the same
names, fails where one differs, and adds the new names to FILE (a version
that computes another function under an old name renames its digest, as the
index bytes were when the k-means++ seeds changed): run parent, change, change, parent
with one file and the f32 outputs of K1 (and its ids on bf16 rows), K2, K3, K4
and K6 and the f32 and int8 key tables of K7 and K8 are held bit for bit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def ptxas_report(_build) -> None:
    for name in ("tilemin.cu", "scan_topk.cu", "stream_topk.cu", "assign.cu", "binscan.cu"):
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
               os.devnull, str(_build.CSRC / name)]
        out = subprocess.run(cmd, capture_output=True, text=True)
        if out.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{out.stdout}\n{out.stderr}")
        lines = out.stderr.splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m and re.search(r"tile_min_kernel|exact_topk_kernel|stream_exact_kernel|"
                               r"assign_kernel|assign_bf16_kernel|screen_kernel|"
                               r"screen_f32_kernel|"
                               r"masked_local_kernel|stream_masked_kernel|"
                               r"binscan_kernel|masked_topk_kernel", m.group(1)):
                kernel = re.search(r"\d+([a-z][a-z0-9_]*_kernel)", m.group(1))
                tile = re.search(r"(FmaTile\w+?EE|Dp4aTile\w+?EE|MmaTile)", m.group(1))
                used = " ".join(l.strip() for l in lines[i + 1 : i + 4])
                used = used.replace("ptxas info    : ", "")
                print(f"ptxas {name} {kernel.group(1) if kernel else ''} "
                      f"{tile.group(1) if tile else m.group(1)}: {used}")


def check_shared_memory(lib) -> None:
    from pqvector_tpu_torch.kernels import assign as ka
    from pqvector_tpu_torch.kernels import score_tile
    from pqvector_tpu_torch.kernels import stream_topk as st

    for backend, nq in (("fma", 64), ("fma", 128), ("wgmma", 128)):
        flag = int(backend == "wgmma")
        got = lib.pqv_tile_min_smem(flag, nq)
        assert got == score_tile.smem_bytes("K9", backend, nq), (backend, nq, got)
        for k in (1, 10, 128):
            got = lib.pqv_exact_topk_smem(flag, nq, k)
            assert got == score_tile.smem_bytes("K5", backend, nq, k), (backend, nq, k)
            assert got <= score_tile.SMEM_LIMIT
            got = lib.pqv_stream_exact_topk_smem(flag, nq, k)
            assert got == score_tile.smem_bytes("K2", backend, nq, k), (backend, nq, k)
            for words in (0, 1, 8):
                want = score_tile.smem_bytes("K4", backend, nq, k, words)
                assert lib.pqv_masked_local_topk_smem(flag, nq, k, words) == want
            assert lib.pqv_stream_masked_topk_smem(flag, k) == st.item_scan_smem(backend, k)
            words = score_tile.table_words(backend, nq, k, 256)
            assert score_tile.smem_bytes("K4", backend, nq, k, words) <= score_tile.SMEM_LIMIT
    assert lib.pqv_assign_smem() == score_tile.smem_bytes("K1", "fma", 128)
    assert lib.pqv_assign_bf16_smem(0) == score_tile.smem_bytes("K1", "fma_bf16", 128)
    assert lib.pqv_assign_bf16_smem(1) == score_tile.smem_bytes("K1", "screen", 128)
    assert lib.pqv_assign_f32_screen_smem() == score_tile.smem_bytes("K1", "screen_f32", 128)
    assert ka.kernel_pairs(lib) == ka.F32_SCREEN_PAIRS, ka.kernel_pairs(lib)
    for backend, nq in (("fma", 64), ("wgmma", 128)):
        for k in (1, 10, 128):
            for kc_pad in (128, 1152, 4224):
                got = lib.pqv_masked_topk_smem(int(backend == "wgmma"), nq, k, kc_pad)
                want = score_tile.smem_bytes("K6", backend, nq, k, kc_pad // 32)
                assert got == want, (backend, nq, k, kc_pad, got, want)
    for code, backend, nq in ((0, "fma", 64), (0, "fma", 128), (1, "wgmma", 128),
                              (2, "dp4a", 64), (2, "dp4a", 128)):
        got = lib.pqv_binned_scan_smem(code, nq)
        assert got == score_tile.smem_bytes("K7", backend, nq), (backend, nq, got)
    print("shared-memory sizes agree with kernels/score_tile.py")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--no-ptxas", action="store_true")
    ap.add_argument("--time-only", action="store_true")
    ap.add_argument("--package-root", default=None)
    ap.add_argument("--digest-file", default=None)
    ap.add_argument("--modes", type=int, default=0)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--share-sweep", action="store_true")
    args = ap.parse_args()
    if args.package_root:
        sys.path.insert(0, os.path.abspath(args.package_root))

    import torch

    import chip_smoke as cs
    from pqvector_tpu_torch.kernels import _build
    from pqvector_tpu_torch.kernels import assign as ka
    from pqvector_tpu_torch.kernels import binscan as bs
    from pqvector_tpu_torch.kernels import scan_topk as sc
    from pqvector_tpu_torch.kernels import stream_topk as st
    from pqvector_tpu_torch.kernels import tilemin as tm

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line(), "| torch", torch.__version__, "CUDA", torch.version.cuda)
    lib = _build.load()
    print(f"nvcc build {_build.build_seconds:.2f} s of {_build.CSRC}")
    if not args.no_ptxas:
        ptxas_report(_build)
    if not args.time_only:
        check_shared_memory(lib)
        cs.phase2_small_k9(torch, tm)
        cs.phase2_score_tile(torch, tm, sc)
        cs.phase2_small_k1_k2(torch, ka, st)
        cs.phase2_small(torch, st, sc, ka)
        cs.phase2_masked_score_tile(torch, st, sc)
        cs.phase2_k6_score_tile(torch, st, sc)
        cs.phase2_binscan_score_tile(torch, bs, bs.quantize_queries_i8)
        cs.phase2_small_slice2(torch, st, sc, bs, bs.quantize_queries_i8)

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    n, d, b, k = args.rows, 128, 256, 10
    n_pad = -(-n // 4096) * 4096
    x = torch.zeros((n_pad, d), device=dev)
    x[:n] = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32)).to(dev)
    if args.modes:
        centres = torch.from_numpy(
            rng.standard_normal((args.modes, d)).astype(np.float32)).to(dev)
        label = torch.from_numpy(np.sort(rng.integers(0, args.modes, n))).to(dev)
        x[:n] = centres[label] + 0.3 * x[:n]
        q = x[torch.from_numpy(rng.integers(0, n, b)).to(dev)] + 0.05 * q
    sq = torch.full((n_pad,), 3.0e38, device=dev)
    sq[:n] = (x[:n] * x[:n]).sum(1)
    digests = {}
    for name, emb in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        got, want = tm.tile_min(q, emb, sq, 128), tm.tile_min_plain(q, emb, sq, 128)
        fin = want < 1e38
        assert torch.equal(fin, got < 1e38)
        err = float((got - want)[fin].abs().max())
        ms = cs.time_ms(lambda: tm.tile_min(q, emb, sq, 128))
        q2 = (-2.0 * q).to(emb.dtype)
        e3, s3 = emb.view(n_pad // 128, 128, d), sq.view(1, n_pad // 128, 128)
        lib_ms = cs.time_ms(lambda: (torch.einsum("bd,gtd->bgt", q2, e3) + s3).amin(dim=2))
        ms1 = cs.time_ms(lambda: tm.tile_min(q[:1], emb, sq, 128))
        print(f"K9 {name} {n} x {d} B={b} tile 128: max err {err:.3g}, kernel {ms:.3f} ms "
              f"(B=1: {ms1:.3f} ms), einsum + amin {lib_ms:.3f} ms")
        qf = q.to(emb.dtype)
        g = sc._final_merge(*sc.exact_scan(qf, emb, sq, k, 1024), k)
        w = sc.final_merge_plain(*sc.exact_scan_plain(qf, emb, sq, k, 1024), k)
        err, swaps = cs.compare_topk(g, w, cs.stored_f64(qf), cs.stored_f64(emb),
                                     sq.cpu().numpy().astype(np.float64))
        ms = cs.time_ms(lambda: sc.exact_scan(qf, emb, sq, k, 1024))
        ms128 = cs.time_ms(lambda: sc.exact_scan(qf, emb, sq, 128, 1024), reps=3)
        lib_ms = cs.time_ms(lambda: torch.topk(sq[None, :] - 2.0 * (qf @ emb.T).float(), k,
                                               dim=1, largest=False))
        print(f"K5 {name} tile 1024 k={k}: {swaps} near-tie swaps, max err {err:.3g}, "
              f"kernel {ms:.3f} ms (k=128: {ms128:.3f} ms), mm + topk {lib_ms:.3f} ms")
        for kk in (1, 10, 100, 128):
            g = st.stream_exact_scan(qf, emb, sq, kk, 4096)
            w = st.stream_exact_scan_plain(qf, emb, sq, kk)
            err, swaps = cs.compare_topk(g, w, cs.stored_f64(qf), cs.stored_f64(emb),
                                         sq.cpu().numpy().astype(np.float64))
            if name == "f32":
                digests[f"K2 f32 k={kk}"] = digest(*g)
            ms = cs.time_ms(lambda: st.stream_exact_scan(qf, emb, sq, kk, 4096))
            ms1 = cs.time_ms(lambda: st.stream_exact_scan(qf[:1], emb, sq, kk, 4096))
            print(f"K2 {name} k={kk}: {swaps} near-tie swaps against plain, max err "
                  f"{err:.3g}, kernel {ms:.3f} ms (B=1: {ms1:.3f} ms)")
    if args.modes:
        masked_section(torch, cs, sc, st, x, sq, centres, label, rng, n, digests)
        k6_section(torch, cs, sc, st, x, sq, centres, label, n, digests)
        binned_section(torch, cs, bs, x, sq, digests)
    cent = x[:1024].contiguous()
    got = ka.assign_rows(x[:n], cent)
    want = ka.assign_rows_plain(x[:n], cent)
    digests["K1 f32"] = digest(got)
    cn = (cent * cent).sum(1)
    ms = cs.time_ms(lambda: ka.assign_rows(x[:n], cent))
    lib_ms = cs.time_ms(lambda: torch.argmin(cn[None, :] - 2.0 * (x[:n] @ cent.T), dim=1),
                        reps=5)
    print(f"K1 {n} x {d}, 1024 centroids: {int((got != want).sum())} ids differ from "
          f"plain, kernel {ms:.3f} ms, mm + argmin {lib_ms:.3f} ms")
    x16 = x[:n].bfloat16()
    got16 = ka.assign_rows(x16, cent)
    differ = int((got16 != ka.assign_rows(x16.float(), cent)).sum())
    digests["K1 bf16 rows"] = digest(got16)
    ms16 = cs.time_ms(lambda: ka.assign_rows(x16, cent))
    print(f"K1 bf16 rows {n} x {d}, 1024 centroids: {differ} ids differ from K1 f32 over "
          f"the widened rows, {ms16:.3f} ms")
    del x16, got16
    if args.sweep:
        k1_sweep(torch, cs, ka)
    if args.share_sweep:
        k1_share_sweep(torch, cs, ka)
    import pqvector_tpu_torch as pqt
    from pqvector_tpu_torch import datasets as ds
    from pqvector_tpu_torch.types import Embeddings

    rows = ds.synthetic_embeddings(n, d)
    index = pqt.build_ivf_index(Embeddings(rows, d), pqt.IvfBuildConfig(n_clusters=1024),
                                device=dev)
    # a package with index/_threefry.py seeds k-means++ as jax.random does: other bytes
    seeds = "jax.random" if (_build.CSRC.parent / "index" / "_threefry.py").exists() else "numpy"
    digests[f"index bytes, IVF-1024, seed 42, {seeds} seeds"] = hashlib.sha256(
        index.to_bytes()).hexdigest()[:16]
    for key, value in digests.items():
        print(f"digest {key}: {value}")
    if args.digest_file:
        want = {}
        if os.path.exists(args.digest_file):
            with open(args.digest_file) as f:
                want = json.load(f)
        shared = [key for key in digests if key in want]
        bad = [key for key in shared if want[key] != digests[key]]
        if bad:
            raise SystemExit(f"outputs differ from {args.digest_file}: {bad}")
        print(f"{len(shared)} digests equal to {args.digest_file}; "
              f"{len(digests) - len(shared)} new ones written to it")
        os.makedirs(os.path.dirname(os.path.abspath(args.digest_file)), exist_ok=True)
        with open(args.digest_file, "w") as f:
            json.dump({**want, **digests}, f)
    print("ok")


def probe(torch, q, centres, c_sq, nprobe):
    """-> (ids [B, nprobe] int32, mask [B, kc_pad] f32): each query's nearest
    centres, ties to the lower id, made here so that two versions of the
    package scan the same probe."""
    ids = torch.argsort(c_sq[None, :] - 2.0 * (q @ centres.T), dim=1, stable=True)
    ids = ids[:, :nprobe].to(torch.int32)
    kc_pad = -(-(centres.shape[0] + 1) // 128) * 128
    mask = torch.zeros((q.shape[0], kc_pad), device=q.device)
    return ids, mask.scatter_(1, ids.long(), 1.0)


def masked_section(torch, cs, sc, st, x, sq, centres, label, rng, n, digests) -> None:
    """K4 and K3 on the cluster-sorted rows ``x`` (mode ``label[r]`` for row r,
    the modes' ``centres`` for centroids): times, skip shares and digests."""
    dev = x.device
    n_pad, d = x.shape
    tile, nprobe, kc = 1024, 8, centres.shape[0]
    rc = np.full(n_pad, kc, np.int32)
    rc[:n] = label.cpu().numpy()
    parts = rc.reshape(-1, tile)
    uniques = [np.unique(p) for p in parts]
    tc_np = np.full((len(parts), max(u.size for u in uniques)), kc, np.int32)
    lcl_np = np.zeros(parts.shape, np.int32)
    for t, u in enumerate(uniques):
        tc_np[t, : u.size] = u
        lcl_np[t] = np.searchsorted(u, parts[t])
    lcl = torch.from_numpy(lcl_np.reshape(-1)).to(dev)
    tc = torch.from_numpy(tc_np).to(dev)
    pick = torch.from_numpy(rng.integers(0, n, 4096)).to(dev)
    noise = torch.from_numpy(rng.standard_normal((4096, d)).astype(np.float32)).to(dev)
    q_all = x[pick] + 0.05 * noise
    c_sq = (centres * centres).sum(1)
    offsets = st.cluster_offsets(torch.from_numpy(rc).to(dev), kc)
    for b in (1, 16, 64, 256, 4096):
        q = q_all[:b].contiguous()
        ids, mask = probe(torch, q, centres, c_sq, nprobe)
        lmask = mask[:, tc.long()].permute(1, 0, 2).contiguous()
        for name, emb in (("f32", x), ("bf16", x.to(torch.bfloat16))):
            qf = q.to(emb.dtype)
            queries = sc.masked_geometry("K4", qf, emb, 10, tc.shape[1])[1]
            chunks = sc.scored_chunks(lmask > 0.5, lcl, tile, queries)
            items, item_chunks = st.scored_items(offsets, ids, st.masked_segments(ids.numel()))
            print(f"K4/K3 {name} B={b} nprobe={nprobe}: K4's blocks of {queries} queries "
                  f"score {int(chunks.any(2).sum())} of "
                  f"{chunks.shape[0] * chunks.shape[1]} (block, tile) pairs and "
                  f"{int(chunks.sum())} of {chunks.numel()} (block, chunk) pairs; K3 "
                  f"{items} items and {item_chunks} (item, chunk) pairs")
            for k in (10, 100):
                a4 = (qf, emb, sq, lcl, lmask, k, tile)
                a3 = (qf, emb, sq, offsets, ids, k)
                g4, g3 = sc.masked_local_scan(*a4), st.stream_masked_scan(*a3)
                torch.cuda.synchronize()
                m4 = sc._final_merge(*g4, k)
                same = bool(torch.equal(m4[1], g3[1]) and torch.equal(m4[0], g3[0]))
                if name == "f32":
                    digests[f"K4 f32 B={b} k={k}"] = digest(*g4)
                    digests[f"K3 f32 B={b} k={k}"] = digest(*g3)
                reps = 3 if b == 4096 else 10
                ms4 = cs.time_ms(lambda: sc.masked_local_scan(*a4), reps=reps)
                ms3 = cs.time_ms(lambda: st.stream_masked_scan(*a3), reps=reps)
                print(f"K4 {name} B={b} k={k} nprobe={nprobe}: {ms4:.3f} ms; K3: {ms3:.3f} "
                      f"ms; K3 equal to K4's merge: {same}")
                del g4, g3, m4


def k6_section(torch, cs, sc, st, x, sq, centres, label, n, digests) -> None:
    """K6 on the rows of ``masked_section`` stored in a seeded random order,
    as a searcher in file order holds them: times, bounds (the rows of the
    probed clusters and the probed pairs' products, as ``chip_smoke.py``
    counts K3's and K4's), the PyTorch chain up to B = 256, and digests of
    the f32 outputs."""
    dev = x.device
    n_pad, d = x.shape
    tile, nprobe, kc = 1024, 8, centres.shape[0]
    perm = torch.from_numpy(np.random.default_rng(11).permutation(n)).to(dev)
    xf = x.clone()
    xf[:n] = x[perm]
    sqf = sq.clone()
    sqf[:n] = sq[perm]
    rc = torch.full((n_pad,), kc, dtype=torch.int32, device=dev)
    rc[:n] = label[perm].to(torch.int32)
    c_sq = (centres * centres).sum(1)
    g = np.random.default_rng(12)
    pick = torch.from_numpy(g.integers(0, n, 4096)).to(dev)
    q_all = xf[pick] + 0.05 * torch.from_numpy(
        g.standard_normal((4096, d)).astype(np.float32)).to(dev)
    for name, emb in (("f32", xf), ("bf16", xf.to(torch.bfloat16))):
        kind = "fp32" if name == "f32" else "bf16"
        for b in (1, 16, 64, 256, 4096):
            q = q_all[:b].contiguous()
            _, mask = probe(torch, q, centres, c_sq, nprobe)
            qf = q.to(emb.dtype)
            for k in (10, 100):
                args = (qf, emb, sqf, rc, mask, k, tile)
                got = sc.masked_scan(*args)
                if name == "f32":
                    digests[f"K6 f32 B={b} k={k}"] = digest(*got)
                del got
                reps = 3 if b == 4096 else 10
                ms = cs.time_ms(lambda: sc.masked_scan(*args), reps=reps)
                row_bytes, ops = cs.probed_work(torch, mask, rc, d, emb.element_size())
                bound = cs.bound_of(row_bytes + cs.nbytes_of(qf, mask)
                                    + (n_pad // tile) * b * k * 8, ops, kind)
                lib = "not timed"
                if b <= 256:
                    lib_ms = cs.masked_library_ms(torch, qf, emb, sqf, rc, mask, k, reps=5)
                    lib = f"{lib_ms:.3f} ms"
                print(f"K6 {name} file order B={b} k={k} nprobe={nprobe}: {ms:.3f} ms, bound "
                      f"{bound['bound_ms']:.3f} ms ({bound['bound_by']}), mm + gathered mask "
                      f"+ topk {lib}")
    del xf, sqf


def binned_section(torch, cs, bs, x, sq, digests) -> None:
    """K7 (every tile) and K8 (a seeded half of the tiles) at tile 2048,
    expand 2 on the rows ``x``: f32, bf16 and int8 codes at B = 1 .. 4096,
    times, bounds, the PyTorch chain up to B = 256, and digests of the f32
    and int8 key tables."""
    dev = x.device
    n_pad, d = x.shape
    tile, expand = 2048, 2
    nt = n_pad // tile
    sel = np.sort(np.random.default_rng(13).permutation(nt)[: nt // 2]).astype(np.int32)
    sel = torch.from_numpy(sel).to(dev)
    g = np.random.default_rng(14)
    noise = torch.from_numpy(g.standard_normal((4096, d)).astype(np.float32)).to(dev)
    q_all = x[torch.from_numpy(g.integers(0, n_pad - tile, 4096)).to(dev)] + 0.05 * noise
    codes, scale = bs.quantize_queries_i8(x)
    arrays = (("f32", x, None, "fp32"), ("bf16", x.to(torch.bfloat16), None, "bf16"),
              ("int8", codes, scale, "int8"))
    for name, emb, sc8, kind in arrays:
        for what, s_ in (("K7", None), ("K8", sel)):
            rows = n_pad if s_ is None else s_.shape[0] * tile
            for b in (1, 16, 64, 256, 4096):
                q = q_all[:b].contiguous()
                if s_ is None:
                    def call():
                        return bs.binned_scan_keys(q, emb, sq, tile, expand, sc8)
                else:
                    def call():
                        return bs.binned_scan_select_keys(q, emb, sq, s_, tile, expand, sc8)
                table = call()
                if name != "bf16":
                    digests[f"{what} {name} B={b}"] = digest(table)
                del table
                ms = cs.time_ms(call, reps=3 if b == 4096 else 10)
                extra = 0 if sc8 is None else rows * 4
                bound = cs.bound_of(rows * (d * emb.element_size() + 4) + extra
                                    + cs.nbytes_of(q) + expand * tile * b * 4,
                                    2.0 * b * rows * d, kind)
                lib = "not timed"
                if b <= 256 and sc8 is None:
                    src = emb if s_ is None else emb.view(-1, tile, d)[s_.long()].reshape(rows, d)
                    lib = f"{cs.binned_library_ms(torch, q, src, expand * tile):.3f} ms"
                    del src
                print(f"{what} {name} tile={tile} expand={expand} rows={rows} B={b}: "
                      f"{ms:.3f} ms, bound {bound['bound_ms']:.3f} ms ({bound['bound_by']}), "
                      f"mm + scatter_reduce(amin) {lib}")


def sweep_data(torch, d, n=1_000_000, k=1000):
    """Seeded 256-mode mixture rows [n, d] on the card (the phase-12
    generator's shape) and k-means centroids trained on 50,000 of them.
    -> (f32 rows, the same rows rounded to bf16, f32 centroids)."""
    from pqvector_tpu_torch.index.kmeans import KMeansParams, k_means

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    modes = torch.from_numpy(np.random.default_rng(1234).uniform(-1, 1, (256, d)).astype(
        np.float32)).to(dev)
    xw = modes[torch.randint(0, 256, (n,), device=dev, generator=gen)] + 0.15 * torch.randn(
        n, d, device=dev, generator=gen)
    sample = xw[torch.randperm(n, device=dev, generator=gen)[:50_000]]
    cent = torch.from_numpy(k_means(sample, KMeansParams(n_clusters=k), device=dev)[0]).to(dev)
    return xw, xw.bfloat16(), cent


def f32_routes(torch, cs, ka, xf, cent, want, res):
    """The f32-row forms on ``xf``: ``pqv_assign`` over every row, the screen
    without its probe (then the re-score) and the screen alone, into ``res``
    (ms) -> (ids that differ from ``want``, the screen's uncertified share;
    None for a package without the f32-row screen)."""
    if not hasattr(ka, "f32_route"):
        return 0, None
    cn = (cent * cent).sum(1).contiguous()
    res["f32 fma"] = cs.time_ms(lambda: ka._assign_cuda(xf, cent, route="fma"), reps=5)
    got = ka._assign_cuda(xf, cent, route="screen", probe=0)
    ids, flags = ka.screen(xf, cent, cn)[:2]
    cert = flags.bool()
    differ = int((got != want).sum()) + int((ids[cert] != want[cert]).sum())
    res["f32 screen"] = cs.time_ms(lambda: ka._assign_cuda(xf, cent, route="screen", probe=0),
                                   reps=5)
    res["f32 screen alone"] = cs.time_ms(lambda: ka.screen(xf, cent, cn), reps=5)
    return differ, 1.0 - float(cert.float().mean())


def k1_sweep(torch, cs, ka) -> None:
    """K1 at 1M x d x 1000 for d = 32 .. 1024 on ``sweep_data``: on the f32
    rows K1's default route (the package's own), ``pqv_assign`` over every
    row and the f32-row screen (unprobed, and alone, with the share it leaves
    uncertified) beside the blocked ``mm`` + ``argmin``;
    on the bf16 rows each route (the screen with its share) and the default
    one beside the blocked ``mm`` + ``argmin`` of the widened rows; the
    function's bound (2nkd at the bf16 tensor rate) beside each form's floor
    (2nkd fp32 FMAs; the screens' 3 x 2nkd). This sets
    ``assign.SCREEN_MIN_DIM`` and ``F32_SCREEN_MIN_DIM``."""
    n, k, block = 1_000_000, 1000, 131072
    routes = hasattr(ka, "bf16_route")  # a package from before the screen has one form
    for d in (32, 64, 96, 128, 256, 512, 768, 1024):
        xf, x16, cent = sweep_data(torch, d, n, k)
        xw = x16.float()
        cn = (cent * cent).sum(1)

        def library(rows):
            for lo in range(0, n, block):
                torch.argmin(cn[None, :] - 2.0 * torch.mm(rows[lo : lo + block].float(), cent.T),
                             dim=1)

        want_f = ka._assign_cuda(xf, cent, route="fma") if hasattr(ka, "f32_route") else \
            ka.assign_rows(xf, cent)
        res = {"K1 f32": cs.time_ms(lambda: ka.assign_rows(xf, cent), reps=5)}
        differ_f = int((ka.assign_rows(xf, cent) != want_f).sum())
        more, share_f = f32_routes(torch, cs, ka, xf, cent, want_f, res)
        differ_f += more
        res["f32 mm + argmin"] = cs.time_ms(lambda: library(xf), reps=3)
        del want_f
        want = ka.assign_rows(xw, cent)
        res["bf16 default"] = cs.time_ms(lambda: ka.assign_rows(x16, cent), reps=5)
        differ = int((ka.assign_rows(x16, cent) != want).sum())
        share = "one form"
        if routes:
            for route in ("fma", "screen"):
                got = ka._assign_cuda(x16, cent, route=route)
                differ += int((got != want).sum())
                res[f"bf16 {route}"] = cs.time_ms(
                    lambda: ka._assign_cuda(x16, cent, route=route), reps=5)
            flags = ka.screen(x16, cent, cn.contiguous())[1]
            share = f"{1.0 - float(flags.float().mean()):.5f} uncertified"
        res["mm + argmin"] = cs.time_ms(lambda: library(x16), reps=3)
        ops = 2.0 * n * k * d
        print(f"K1 sweep 1M x {d} x {k}: " + ", ".join(f"{key} {v:.3f} ms" for key, v in
                                                       res.items())
              + f"; {differ_f} f32-row ids differ from pqv_assign, f32-row screen "
              f"{share_f} uncertified; {differ} bf16-row ids differ from K1 f32; "
              f"bf16-row screen {share}; bound "
              f"{max(ops / 989e12, (x16.numel() * 2 + cent.numel() * 4 + n * 4) / 3.35e12) * 1e3:.3f}"
              f" ms, floors fp32 {ops / 67e12 * 1e3:.3f} ms, screens {3 * ops / 989e12 * 1e3:.3f}"
              f" ms; " + cs.card_line())
        del xf, x16, xw, cent, want
        torch.cuda.empty_cache()


def k1_share_sweep(torch, cs, ka) -> None:
    """K1 at 1M x d x 1000 on ``sweep_data`` with m pairs of centroids made
    equal (centroid 2i + 1 := centroid 2i for i < m): on the bf16 rows the
    FMA form, the screen without its probe and the default route, with the
    share the screen leaves uncertified; on the f32 rows ``pqv_assign``, the
    f32-row screen without its probe and the default route; then the share
    where each unprobed screen and its FMA form cross, by linear
    interpolation between the sweep's points (``assign.RESCORE_BREAK_EVEN``
    and ``RESCORE_BREAK_EVEN_F32`` come from it)."""
    n, k = 1_000_000, 1000
    f32 = hasattr(ka, "f32_route")
    for d in (64, 96, 128, 512, 1024):
        xf, x16, cent = sweep_data(torch, d, n, k)
        points, points_f = [], []
        for m in (0, 125, 250, 375, 500):
            ct = cent.clone()
            ct[1 : 2 * m : 2] = cent[0 : 2 * m : 2]
            want = ka.assign_rows(x16.float(), ct)
            ka.reset_screen_counts()
            got = ka._assign_cuda(x16, ct, route="screen", probe=0)
            share = ka.SCREENED["uncertified"] / n
            ka.reset_screen_counts()
            differ = int((got != want).sum()) + int((ka.assign_rows(x16, ct) != want).sum())
            sent = ka.SCREENED["fma_after_probe"]
            res = {"fma": cs.time_ms(lambda: ka._assign_cuda(x16, ct, route="fma"), reps=5),
                   "screen unprobed": cs.time_ms(
                       lambda: ka._assign_cuda(x16, ct, route="screen", probe=0), reps=5),
                   "default": cs.time_ms(lambda: ka.assign_rows(x16, ct), reps=5),
                   "screen alone": cs.time_ms(
                       lambda: ka.screen(x16, ct, (ct * ct).sum(1).contiguous()), reps=5)}
            points.append((share, res["screen unprobed"] - res["fma"]))
            line = ""
            if f32:
                want_f = ka._assign_cuda(xf, ct, route="fma")
                differ_f, share_f = f32_routes(torch, cs, ka, xf, ct, want_f, res)
                ka.reset_screen_counts()
                differ_f += int((ka.assign_rows(xf, ct) != want_f).sum())
                sent_f = ka.SCREENED["f32_fma_after_probe"]
                res["f32 default"] = cs.time_ms(lambda: ka.assign_rows(xf, ct), reps=5)
                points_f.append((share_f, res["f32 screen"] - res["f32 fma"]))
                line = (f"; f32 rows: uncertified {share_f:.5f}, the probe sent it to "
                        f"pqv_assign: {bool(sent_f)}, {differ_f} ids differ from pqv_assign")
                del want_f
            print(f"K1 share sweep 1M x {d} x {k}, {m} equal pairs: uncertified {share:.5f}, "
                  + ", ".join(f"{key} {v:.3f} ms" for key, v in res.items())
                  + f"; the probe sent it to the FMA form: {bool(sent)}; {differ} ids differ "
                  f"from K1 f32{line}; " + cs.card_line())
            del ct, want, got
        print(f"K1 share sweep 1M x {d} x {k}: the unprobed screen and the FMA form cross at "
              f"an uncertified share of {crossing(points)}"
              + (f"; on f32 rows the unprobed f32-row screen and pqv_assign at "
                 f"{crossing(points_f)}" if points_f else ""))
        del xf, x16, cent
        torch.cuda.empty_cache()


def crossing(points):
    """The share at which (share, screen ms - FMA ms) points cross zero, by
    linear interpolation; None where they do not."""
    return next((s0 + (s1 - s0) * -g0 / (g1 - g0) for (s0, g0), (s1, g1)
                 in zip(points, points[1:]) if g0 < 0 <= g1), None)


def digest(*tensors) -> str:
    """SHA-256 over the bytes of device tensors."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


if __name__ == "__main__":
    main()
