"""Index build benchmark: a timed in-place build of a synthetic file with
its size overhead.

Counterpart of ``pqvector_tpu/bench/index_build.py`` (pq-vector
benches/index_build.rs)::

    python -m pqvector_tpu_torch.bench.index_build [--rows N] [--dim N]
        [--n-clusters N] [--device D]
"""

from __future__ import annotations

import argparse
import os
import time

from ..builder import IndexBuilder
from .datasets import synthetic_embeddings, write_embedding_parquet


def main(argv: list[str] | None = None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("--rows", type=int, default=1_000_000)
    parser.add_argument("--dim", type=int, default=1024)
    parser.add_argument("--n-clusters", type=int, default=None)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    os.makedirs("data", exist_ok=True)
    path = os.path.join("data", f"build_bench_{args.rows}x{args.dim}.parquet")
    if not os.path.exists(path):
        print(f"generating {args.rows}x{args.dim} synthetic parquet")
        t0 = time.perf_counter()
        write_embedding_parquet(path, synthetic_embeddings(args.rows, args.dim))
        print(f"generated in {time.perf_counter() - t0:.2f}s")
    original = os.path.getsize(path)

    builder = IndexBuilder(path, "embedding", device=args.device)
    if args.n_clusters:
        builder = builder.n_clusters(args.n_clusters)
    t0 = time.perf_counter()
    builder.build_inplace()
    build_s = time.perf_counter() - t0
    indexed = os.path.getsize(path)
    print(f"Index build time: {build_s:.2f}s")
    print(
        f"Size overhead: {(indexed - original) / 1e6:.2f} MB "
        f"({(indexed - original) / original * 100:.2f}%)"
    )
    return {"build_s": build_s, "overhead_bytes": indexed - original}


if __name__ == "__main__":
    main()
