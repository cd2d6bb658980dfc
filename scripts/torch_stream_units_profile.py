"""Kernel and merge time of K2 (streaming exact top-k) by batch, k and the
number of row runs, on one Hopper GPU.

    python3 scripts/torch_stream_units_profile.py [--rows 1000000]

Needs a card, nvcc and the repo root as the working directory. For f32 and
bf16 storage of ``--rows`` x 128 random rows, B = 1 and 256 and k = 10, 100
and 128 it launches K2 with the split ``scan_units`` picks and with 66, 132,
264 and 528 runs, under torch.profiler, and prints the device time of the
two launches (the scan and the merge of the partial lists) per call. It
shows where one wave of blocks lies for a k (two blocks fit an SM's shared
memory at small k, one at large k) and what more runs cost in list fills
and in the merge.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from pqvector_tpu_torch.kernels import score_tile
    from pqvector_tpu_torch.kernels import stream_topk as st

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(cs.card_line())
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    n, d, reps = args.rows, 128, 5
    n_pad = -(-n // 4096) * 4096
    x = torch.zeros((n_pad, d), device=dev)
    x[:n] = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32)).to(dev)
    sq = torch.full((n_pad,), 3.0e38, device=dev)
    sq[:n] = (x[:n] * x[:n]).sum(1)
    q = torch.from_numpy(rng.standard_normal((256, d)).astype(np.float32)).to(dev)
    for name, emb in (("f32", x), ("bf16", x.to(torch.bfloat16))):
        for b in (1, 256):
            qf = q[:b].to(emb.dtype).contiguous()
            backend = score_tile.pick_backend(emb.dtype, d, qf.data_ptr(), emb.data_ptr())
            queries = score_tile.block_queries(b, backend)
            for k in (10, 100, 128):
                wave = score_tile.wave_blocks(score_tile.smem_bytes("K2", backend, queries, k))
                picked = st.scan_units(n_pad // 128, b, queries, wave)
                for units in dict.fromkeys((picked, 66, 132, 264, 528)):
                    st._stream_exact_cuda(qf, emb, sq, k, units=units)
                    torch.cuda.synchronize()
                    with profile(activities=[ProfilerActivity.CUDA]) as prof:
                        for _ in range(reps):
                            st._stream_exact_cuda(qf, emb, sq, k, units=units)
                        torch.cuda.synchronize()
                    ms = {"scan": 0.0, "merge": 0.0}
                    for e in prof.key_averages():
                        for key in ms:
                            if ("stream_exact" if key == "scan" else "merge_partials") in e.key:
                                ms[key] += e.self_device_time_total / 1e3 / reps
                    tag = " (picked)" if units == picked else ""
                    print(f"K2 {name} B={b} k={k} wave={wave} units={units}{tag}: scan "
                          f"{ms['scan']:.3f} ms, merge {ms['merge']:.3f} ms")
    print("ok")


if __name__ == "__main__":
    main()
