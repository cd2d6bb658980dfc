"""Where K4's, K3's and K6's time goes on one Hopper GPU: the walk, the
dumps with their barriers, and the list work.

    python3 scripts/torch_masked_epilogue_profile.py [--rows 1000000]

Needs a card, nvcc and the repo root as the working directory. It builds the
kernels three times, each in a process of its own: as they are; with
``-DPQV_PROFILE_NO_DRAIN`` (``csrc/topk_lists.cuh``: the probe flags, the
dumps and both barriers of a half stay, no score enters a list); and with
``-DPQV_PROFILE_NO_EPILOGUE`` (the chunks are copied and multiplied, nothing
else; on the fp32 back end the compiler then drops the products too, so only
the bf16 column says what the walk costs). Each build times K4, K3 and, as a
yardstick for a full walk, K9 on ``--rows`` x 128 cluster-sorted rows of 1024
modes (tiles of 1024 rows, nprobe 8, k = 10), and K6 on the same rows in a
seeded random order (a layout in file order), at B = 256 and 16, in bf16 and
f32, with 20 launches between two CUDA events, so the host's share of a
single launch is not in the numbers. The two profile builds return wrong
results by design; nothing else uses those flags.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
BUILDS = ("", "-DPQV_PROFILE_NO_DRAIN", "-DPQV_PROFILE_NO_EPILOGUE")


def device_ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def one_build(flag: str, rows: int) -> None:
    import torch

    import chip_smoke as cs
    from pqvector_tpu_torch.kernels import _build

    _build.NVCC_FLAGS += flag.split()
    from pqvector_tpu_torch.kernels import scan_topk as sc
    from pqvector_tpu_torch.kernels import stream_topk as st
    from pqvector_tpu_torch.kernels import tilemin as tm
    from pqvector_tpu_torch.kernels.probe import probe_ids, probe_mask

    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    d, modes, tile = 128, 1024, 1024
    n_pad = -(-rows // 4096) * 4096
    centres = torch.from_numpy(rng.standard_normal((modes, d)).astype(np.float32)).to(dev)
    label = np.sort(rng.integers(0, modes, rows))
    x = torch.zeros((n_pad, d), device=dev)
    noise = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(dev)
    x[:rows] = centres[torch.from_numpy(label).to(dev)] + 0.3 * noise
    sq = torch.full((n_pad,), 3.0e38, device=dev)
    sq[:rows] = (x[:rows] * x[:rows]).sum(1)
    rc = np.full(n_pad, modes, np.int32)
    rc[:rows] = label
    parts = rc.reshape(-1, tile)
    uniques = [np.unique(p) for p in parts]
    tc_np = np.full((len(parts), max(u.size for u in uniques)), modes, np.int32)
    lcl_np = np.zeros(parts.shape, np.int32)
    for t, u in enumerate(uniques):
        tc_np[t, : u.size] = u
        lcl_np[t] = np.searchsorted(u, parts[t])
    lcl = torch.from_numpy(lcl_np.reshape(-1)).to(dev)
    tc = torch.from_numpy(tc_np).to(dev)
    pick = torch.from_numpy(rng.integers(0, rows, 256)).to(dev)
    q_all = x[pick] + 0.05 * torch.from_numpy(
        rng.standard_normal((256, d)).astype(np.float32)).to(dev)
    c_sq = (centres * centres).sum(1)
    perm = torch.from_numpy(np.random.default_rng(11).permutation(rows)).to(dev)
    xf, sqf = x.clone(), sq.clone()
    xf[:rows], sqf[:rows] = x[perm], sq[perm]
    rcf = torch.full((n_pad,), modes, dtype=torch.int32, device=dev)
    rcf[:rows] = torch.from_numpy(label).to(dev)[perm].to(torch.int32)
    out = [flag or "as built", cs.card_line()]
    for b in (256, 16):
        q = q_all[:b].contiguous()
        mask = probe_mask(q, centres, c_sq, 8)
        probe = probe_ids(q, centres, c_sq, 8)
        offsets = st.cluster_offsets(torch.from_numpy(rc).to(dev), modes)
        lmask = mask[:, tc.long()].permute(1, 0, 2).contiguous()
        for name, emb, embf in (("bf16", x.to(torch.bfloat16), xf.to(torch.bfloat16)),
                                ("f32", x, xf)):
            qf = q.to(emb.dtype)
            a4 = (qf, emb, sq, lcl, lmask, 10, tile)
            a3 = (qf, emb, sq, offsets, probe, 10)
            a6 = (qf, embf, sqf, rcf, mask, 10, tile)
            out.append(
                f"B={b} {name}: K4 {device_ms(torch, lambda: sc.masked_local_scan(*a4)):.3f} "
                f"K3 {device_ms(torch, lambda: st.stream_masked_scan(*a3)):.3f} "
                f"K6 {device_ms(torch, lambda: sc.masked_scan(*a6)):.3f} "
                f"K9 {device_ms(torch, lambda: tm.tile_min(q, emb, sq, 128)):.3f} ms")
    print(" | ".join(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--build", default=None, help="one build's flag (set by this script)")
    args = ap.parse_args()
    if args.build is not None:
        one_build(args.build, args.rows)
        return
    for flag in BUILDS:
        done = subprocess.run([sys.executable, os.path.abspath(__file__), "--rows",
                               str(args.rows), f"--build={flag}"])
        if done.returncode:
            raise SystemExit(f"the build with {flag!r} failed")
    print("ok")


if __name__ == "__main__":
    main()
