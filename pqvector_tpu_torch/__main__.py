"""Command-line utilities.

    python -m pqvector_tpu_torch info <file.parquet>      # index metadata + stats
    python -m pqvector_tpu_torch build <file.parquet> --column embedding [...]
    python -m pqvector_tpu_torch search <file.parquet> --query-row N [-k K] [--nprobe P]

``build`` and ``search --device-mode`` run on the CUDA card unless
``--device`` names another torch device (``--device cpu`` runs the kernels'
plain versions); ``search`` without ``--device-mode`` is host code and uses
no device.
What the port does not carry out (``build --output``, ``--transfer-dtype``)
and errors of the input exit with code 1 and one line on stderr.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from .errors import PqVectorError


def _device(args):
    from ._device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as exc:
        raise PqVectorError(str(exc)) from exc


def cmd_info(args) -> int:
    from .io.embed import (
        has_pq_vector_index,
        read_index_from_parquet,
        read_index_metric,
    )

    if not has_pq_vector_index(args.path):
        print(f"{args.path}: no pq-vector index")
        return 1
    index, column = read_index_from_parquet(args.path)
    sizes = index.cluster_sizes()
    print(f"{args.path}:")
    print(f"  embedding column : {column}")
    print(f"  metric           : {read_index_metric(args.path)}")
    print(f"  dimension        : {index.dim}")
    print(f"  clusters         : {index.n_clusters}")
    print(f"  rows             : {index.total_rows}")
    print(
        f"  cluster sizes    : min={sizes.min()} max={sizes.max()} "
        f"mean={sizes.mean():.1f} empty={(sizes == 0).sum()}"
    )
    print(f"  index bytes      : {len(index.to_bytes())}")
    return 0


def cmd_build(args) -> int:
    from .builder import IndexBuilder

    builder = IndexBuilder(args.path, args.column, device=_device(args))
    builder = builder.metric(args.metric)
    if args.transfer_dtype != "auto":
        builder = builder.transfer_dtype(args.transfer_dtype)
    if args.n_clusters:
        builder = builder.n_clusters(args.n_clusters)
    if args.seed is not None:
        builder = builder.seed(args.seed)
    if args.output:
        if args.cluster_sorted:
            builder = builder.cluster_sorted()
        builder.build_new(args.output)
        print(f"indexed copy written to {args.output}")
    else:
        builder.build_inplace()
        print(f"index embedded in place in {args.path}")
    return 0


def cmd_search(args) -> int:
    import pyarrow.parquet as pq

    from .query.search import TopkBuilder

    table = pq.read_table(args.path, columns=[args.column])
    query = np.asarray(table.column(args.column)[args.query_row].as_py(), np.float32)
    if args.device_mode:
        # Device-resident search (serving path); "scan" is the over-fetch
        # full scan, "auto" the measured-best exact-selection kernel (see
        # DeviceIvfSearcher.search).
        from .query.device import DeviceIvfSearcher

        searcher = DeviceIvfSearcher.from_parquet(args.path, device=_device(args))
        dists, ids = searcher.search(
            query[None, :], args.k, args.nprobe, mode=args.device_mode
        )
        for i, d in zip(ids[0].cpu().numpy(), dists[0].cpu().numpy()):
            if i >= 0:
                print(f"{int(i)}\t{float(d):.6f}")
        return 0
    results = TopkBuilder(args.path, query).k(args.k).nprobe(args.nprobe).search()
    for r in results:
        print(f"{r.row_idx}\t{r.distance:.6f}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="pqvector_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("info", help="show embedded index metadata")
    p.add_argument("path")
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("build", help="build an IVF index")
    p.add_argument("path")
    p.add_argument("--column", default="embedding")
    p.add_argument("--n-clusters", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--metric", choices=["l2", "cosine"], default="l2")
    p.add_argument("--output", default=None, help="write an indexed copy instead")
    p.add_argument("--cluster-sorted", action="store_true")
    p.add_argument(
        "--transfer-dtype", choices=["auto", "float32", "bfloat16"],
        default="auto",
        help="host->device wire dtype for the build transfer (not ported: "
        "only auto is accepted)",
    )
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("search", help="top-k search using a file row as query")
    p.add_argument("path")
    p.add_argument("--column", default="embedding")
    p.add_argument("--query-row", type=int, default=0)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--nprobe", type=int, default=8)
    p.add_argument(
        "--device-mode", default=None,
        choices=["auto", "stream", "pallas", "masked", "gather", "approx",
                 "scan"],
        help="serve from the device-resident searcher in this mode instead of "
        "the disk-selective TopkBuilder path",
    )
    p.add_argument("--device", default=None,
                   help="torch device of --device-mode (default: the CUDA "
                   "card); the host path uses none")
    p.set_defaults(fn=cmd_search)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except PqVectorError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
