"""K3's scan (``kernels/stream_topk.py``: ``stream_masked_scan``) on one
Hopper GPU: timed, and its f32 distances and ids digested, so that two
checkouts of the package can be run in turns in one call and held bit for
bit.

    python3 scripts/torch_k3_check.py [--package-root DIR] [--digest-file FILE]
        [--label NAME] [--shapes NAME,...]

Needs a card and the repo root as the working directory. The rows are
seeded Gaussian modes (uniform centres in [-1, 1]^d, 0.15 N(0, 1) around
them) stored mode by mode, as a cluster-sorted searcher holds them, with the
mode centres for centroids; queries are rows plus 0.05 N(0, 1). Shapes:

- ``1m128``: 1M x 128, 1,024 clusters, nprobe 8, k = 10, B = 256 in bf16
  and f32 (``chip_smoke.py`` phase 2b's K3) and B = 1 in bf16 (the
  ``sift1m.search.b1`` cell's batch);
- ``1m1024``: 1M x 1024, 1,000 clusters, nprobe 16, k = 100, B = 256, bf16
  (the ``ref1024.search.b256`` cell's shape);
- ``10m96``: 10M x 96, 4,096 clusters, nprobe 4, k = 10, B = 256 (phase 7b)
  and B = 4096 (the ``deep10m.search.b4096`` cell's batch), bf16.

The C source's shared-memory sizes are held to the wrapper's reckoning
first. For each shape, the scan's time on the card (CUDA events around 10
calls after two of warm-up, the median), its device time by kernel from a
``torch.profiler`` trace of 10 calls (``k3_split_ms``: the count, the plan,
the scan and the partial merge, ms a call), with K3's trace counters, and
both of ``search``'s routes on a sorted layout, probe and f32 re-score
included: ``k3_route_ms`` (``stream_masked_topk``) and, at B <= 256,
``k4_route_ms`` (``masked_local_topk``: the local mask's gather, K4, the
cross-tile merge) with the share of ids in which the two routes' answers
differ. ``--package-root DIR`` takes ``pqvector_tpu_torch`` from another
checkout (say, the parent commit unpacked with ``git archive`` under
``build/``); the inputs, the probe ids and mask among them, are the same
tensors, made here from seeds. ``--digest-file FILE`` holds each
shape's digest to the one FILE has under its name, fails where one differs
and adds new names: run parent, change, change, parent with one file. Each
process prints one JSON line a shape.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
from collections import defaultdict

import numpy as np
from torch_score_tile_check import probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SHAPES = {  # name: (rows, d, clusters, nprobe, k, [(B, storage)])
    "1m128": (1_000_000, 128, 1024, 8, 10, [(256, "bf16"), (256, "f32"), (1, "bf16")]),
    "1m1024": (1_000_000, 1024, 1000, 16, 100, [(256, "bf16")]),
    "10m96": (10_000_000, 96, 4096, 4, 10, [(256, "bf16"), (4096, "bf16")]),
}
TILE = 1024
#: K3's launch by kernel name: the pair count, the plan, the scan, the merge.
K3_KERNELS = ("k3_count_kernel", "k3_plan_kernel", "stream_masked_kernel",
              "merge_partials_kernel")


def make_rows(torch, n, d, clusters, seed):
    """-> (rows f32 [n_pad, d], norms with +3e38 pads, row clusters with
    ``clusters`` on pads, centres [clusters, d])."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    centres = torch.rand((clusters, d), generator=g, device=dev) * 2 - 1
    label = torch.randint(0, clusters, (n,), generator=g, device=dev).sort().values
    n_pad = -(-(n + 1) // TILE) * TILE
    x = torch.zeros((n_pad, d), device=dev)
    x[:n] = centres[label] + 0.15 * torch.randn((n, d), generator=g, device=dev)
    sq = torch.full((n_pad,), 3.0e38, device=dev)
    sq[:n] = (x[:n] * x[:n]).sum(1)
    rc = torch.full((n_pad,), clusters, dtype=torch.int32, device=dev)
    rc[:n] = label.to(torch.int32)
    return x, sq, rc, centres


def tile_tables(torch, rc):
    """The searcher's (local_cluster, tile_clusters) of sorted row clusters."""
    parts = rc.cpu().numpy().reshape(-1, TILE)
    uniques = [np.unique(p) for p in parts]
    tc = np.full((len(parts), max(u.size for u in uniques)), int(parts[-1, -1]), np.int32)
    lcl = np.zeros(parts.shape, np.int32)
    for t, u in enumerate(uniques):
        tc[t, : u.size] = u
        lcl[t] = np.searchsorted(u, parts[t])
    return (torch.from_numpy(lcl.reshape(-1)).cuda(), torch.from_numpy(tc).cuda())


def device_ms(torch, fn, reps=10):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernel_split_ms(torch, fn, names, reps=10):
    """Device ms a call of each kernel whose name holds one of ``names``,
    from a CUDA-only ``torch.profiler`` trace of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    us = defaultdict(float)
    for e in events:
        if e.get("cat") == "kernel":
            for name in names:
                if name in e.get("name", ""):
                    us[name] += e.get("dur", 0.0)
    return {name: round(us[name] / 1e3 / reps, 4) for name in names}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", default=ROOT)
    ap.add_argument("--digest-file")
    ap.add_argument("--label", default="change")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.package_root))
    import torch

    from pqvector_tpu_torch.kernels import scan_topk as sc
    from pqvector_tpu_torch.kernels import stream_topk as st
    from pqvector_tpu_torch.utils import profiling

    assert os.path.abspath(st.__file__).startswith(os.path.abspath(args.package_root))
    lib = st._build.load()  # both packages build before anything is timed
    for flag, backend in ((0, "fma"), (1, "wgmma")):  # the C source's shared memory
        for k in (1, 10, 128):
            assert lib.pqv_stream_masked_topk_smem(flag, k) == st.item_scan_smem(backend, k)
    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    want = {}
    if args.digest_file and os.path.exists(args.digest_file):
        with open(args.digest_file) as f:
            want = json.load(f)
    digests, bad = {}, []
    for shape in args.shapes.split(","):
        n, d, clusters, nprobe, k, runs = SHAPES[shape]
        x, sq, rc, centres = make_rows(torch, n, d, clusters, seed=n + d)
        lcl, tc = tile_tables(torch, rc)
        c_sq = (centres * centres).sum(1)
        pick = torch.randint(0, n, (4096,), generator=torch.Generator(device="cuda")
                             .manual_seed(7), device="cuda")
        q_all = x[pick] + 0.05 * torch.randn((4096, d), device="cuda", generator=torch
                                             .Generator(device="cuda").manual_seed(8))
        for b, storage in runs:
            emb = x if storage == "f32" else x.to(torch.bfloat16)
            q = q_all[:b].contiguous()
            qf = q.to(emb.dtype)
            ids, _ = probe(torch, q, centres, c_sq, nprobe)
            offsets = st.cluster_offsets(rc, clusters)
            a3 = (qf, emb, sq, offsets, ids, k)
            got = st.stream_masked_scan(*a3)
            torch.cuda.synchronize()
            name = f"{shape} {storage} B={b} nprobe={nprobe}" + (f" k={k}" if k != 10 else "")
            h = hashlib.sha256(got[0].cpu().numpy().tobytes())
            h.update(got[1].cpu().numpy().tobytes())
            digests[name] = h.hexdigest()[:16]
            if name in want and want[name] != digests[name]:
                bad.append(name)
            line = {"label": args.label, "shape": name, "card": card,
                    "ms": round(device_ms(torch, lambda: st.stream_masked_scan(*a3)), 4),
                    "k3_split_ms": kernel_split_ms(torch, lambda: st.stream_masked_scan(*a3),
                                                   K3_KERNELS),
                    "digest": digests[name], "same_as_file": want.get(name, digests[name])
                    == digests[name]}

            def k3_route():
                return st.stream_masked_topk(q, centres, c_sq, offsets, emb, sq, nprobe, k,
                                             emb_ref=x)

            line["k3_route_ms"] = round(device_ms(torch, k3_route), 4)
            if b <= 256:  # K4's route at this batch: the local mask's gather, K4, the merge
                def k4_route():
                    return sc.masked_local_topk(q, centres, c_sq, lcl, tc, emb, sq, nprobe, k,
                                                TILE, emb_ref=x)

                line["k4_route_ms"] = round(device_ms(torch, k4_route), 4)
                line["routes_ids_differ"] = round(
                    float((k3_route()[1] != k4_route()[1]).float().mean()), 6)
            profiling.clear_store()
            with profiling.tracing():
                st.stream_masked_scan(*a3)
            items, chunks = (profiling.read_store()["counters"][key] for key in st.K3_COUNTERS)
            profiling.clear_store()
            line.update(items=items, chunks=chunks,
                        rows_read_pct=round(100.0 * chunks * 128 / n, 2),
                        segments=st.masked_segments(b * nprobe),
                        nvidia_smi=smi)
            print(json.dumps(line), flush=True)
            del emb, qf, got, a3
        del x, sq, rc, lcl, tc
        torch.cuda.empty_cache()
    if args.digest_file:
        with open(args.digest_file, "w") as f:
            json.dump({**want, **digests}, f)
    if bad:
        raise SystemExit(f"digests differ from {args.digest_file}: {bad}")


if __name__ == "__main__":
    main()
