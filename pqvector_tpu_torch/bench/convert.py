"""Convert standard ANN benchmark files (fvecs/bvecs) to indexed Parquet.

Counterpart of ``pqvector_tpu/bench/convert.py``::

    python -m pqvector_tpu_torch.bench.convert --input sift_base.fvecs \
        --output sift.parquet [--n-clusters 1024] [--metric l2] [--max-rows N] \
        [--no-index] [--device D]

Writes the synthetic generator's (id, embedding) layout and embeds the IVF
index in place (on the CUDA card unless ``--device`` says otherwise), so
the output serves every query path of both packages.
"""

from __future__ import annotations

import argparse
import os
import time

from ..builder import IndexBuilder
from .datasets import read_bvecs, read_fvecs, write_embedding_parquet


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--input", required=True)
    parser.add_argument("--output", required=True)
    parser.add_argument("--column", default="embedding")
    parser.add_argument("--n-clusters", type=int, default=None)
    parser.add_argument("--metric", choices=["l2", "cosine"], default="l2")
    parser.add_argument("--max-rows", type=int, default=None)
    parser.add_argument("--no-index", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    t0 = time.perf_counter()
    if args.input.endswith(".bvecs"):
        mat = read_bvecs(args.input, max_rows=args.max_rows)
    else:
        mat = read_fvecs(args.input, max_rows=args.max_rows)
    print(f"loaded {mat.shape} from {args.input} in {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    write_embedding_parquet(args.output, mat, column=args.column)
    print(f"wrote {args.output} in {time.perf_counter() - t0:.1f}s "
          f"({os.path.getsize(args.output) / 1e6:.1f} MB)")

    if not args.no_index:
        t0 = time.perf_counter()
        builder = IndexBuilder(args.output, args.column, device=args.device)
        builder = builder.metric(args.metric)
        if args.n_clusters:
            builder = builder.n_clusters(args.n_clusters)
        builder.build_inplace()
        print(f"indexed in {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
