"""Query + recall benchmark harness.

Counterpart of ``pqvector_tpu/bench/harness.py``, after the reference's
benches/query.rs: generate or load a dataset, run the **unindexed** SQL
query as ground truth, build the index (in place and/or rewritten, timed,
with the size overhead), run the indexed query and report recall@k against
the ground truth. The same flags, plus ``--device`` (default: the CUDA
card; ``cpu`` runs the plain versions)::

    python -m pqvector_tpu_torch.bench.harness [--path P] [--vector-column C]
        [--id-column C] [--build-mode inplace|rewrite|both] [--nprobe N]
        [--max-candidates N] [--n-clusters N] [--k N] [--query-row N]
        [--metrics] [--rows N] [--dim N] [--device D]
"""

from __future__ import annotations

import argparse
import os
import shutil
import time

import numpy as np

from ..builder import IndexBuilder
from ..engine import Session, VectorTopKOptions, tree_render
from ..io.reader import infer_vector_dim, read_embedding_column
from ..types import EmbeddingColumn
from .datasets import random_query, synthetic_embeddings, write_embedding_parquet

DEFAULT_ROWS = 1_000_000  # benches/query.rs:27
DEFAULT_DIM = 1024  # benches/query.rs:28
DEFAULT_K = 100  # benches/query.rs:30
DEFAULT_NPROBE = 16  # benches/query.rs:31


def _mb(n: int) -> float:
    return n / (1024 * 1024)


def _array_literal(vec: np.ndarray) -> str:
    return "[" + ", ".join(repr(float(v)) for v in vec) + "]"


def _extract_keys(table, id_column: str | None) -> list:
    if id_column and id_column in table.column_names:
        return table.column(id_column).to_pylist()
    # No id column: match rows by their vectors (query.rs's vector hash).
    col = table.column(table.column_names[0])
    return [tuple(v) if isinstance(v, list) else v for v in col.to_pylist()]


def _timed_build(builder: IndexBuilder, n_clusters, build, label: str,
                 source_size: int, path: str) -> float:
    if n_clusters:
        builder = builder.n_clusters(n_clusters)
    print(f"\n=== Building IVF index ({label}) ===")
    t0 = time.perf_counter()
    build(builder)
    build_time = time.perf_counter() - t0
    size = os.path.getsize(path)
    print(
        f"Index build time: {build_time:.2f}s; size {_mb(size):.2f} MB "
        f"(+{(size - source_size) / source_size * 100:.1f}%)"
    )
    return build_time


def run(args: argparse.Namespace) -> dict:
    device = getattr(args, "device", None)
    data_dir = "data"
    os.makedirs(data_dir, exist_ok=True)

    if args.path:
        source = args.path
    else:
        source = os.path.join(data_dir, f"query_bench_{args.rows}x{args.dim}.parquet")
        if not os.path.exists(source):
            print(f"=== Generating synthetic dataset ({args.rows}x{args.dim}) ===")
            t0 = time.perf_counter()
            write_embedding_parquet(source, synthetic_embeddings(args.rows, args.dim))
            print(f"Generated parquet in {time.perf_counter() - t0:.2f}s")
    source_size = os.path.getsize(source)
    print(f"Source parquet size: {_mb(source_size):.2f} MB")

    column = args.vector_column
    dim = infer_vector_dim(source, EmbeddingColumn(column))
    if args.query_row is not None:
        query = read_embedding_column(source, EmbeddingColumn(column)).data[args.query_row]
    else:
        query = random_query(dim)
    select = args.id_column or column
    sql = (
        f"SELECT {select} FROM t ORDER BY "
        f"array_distance({column}, {_array_literal(query)}) LIMIT {args.k}"
    )

    # --- Ground truth: the unindexed query (query.rs:76-103) ---
    print("\n=== Vector search without index ===")
    plain = Session(enable_vector_topk=False, device=device)
    plain.register_parquet("t", source)
    df = plain.sql(sql)
    t0 = time.perf_counter()
    plain_table = df.collect()
    plain_time = time.perf_counter() - t0
    plain_keys = _extract_keys(plain_table, args.id_column)
    print(f"Query time (no index): {plain_time:.3f}s, rows={plain_table.num_rows}")
    results = {"plain_time_s": plain_time}

    # --- Builds ---
    paths = {}
    if args.build_mode in ("rewrite", "both"):
        rewrite = os.path.join(data_dir, "query_bench_rewrite.parquet")
        results["rewrite_build_s"] = _timed_build(
            IndexBuilder(source, column, device=device), args.n_clusters,
            lambda b: b.build_new(rewrite), "rewrite", source_size, rewrite,
        )
        paths["rewrite"] = rewrite
    if args.build_mode in ("inplace", "both"):
        inplace = os.path.join(data_dir, "query_bench_inplace.parquet")
        shutil.copyfile(source, inplace)
        results["inplace_build_s"] = _timed_build(
            IndexBuilder(inplace, column, device=device), args.n_clusters,
            lambda b: b.build_inplace(), "in-place", source_size, inplace,
        )
        paths["inplace"] = inplace

    # --- Indexed queries + recall (query.rs:154-194) ---
    options = VectorTopKOptions(nprobe=args.nprobe, max_candidates=args.max_candidates)
    for label, path in paths.items():
        print(f"\n=== Vector search with index ({label}) ===")
        ctx = Session(options, device=device)
        ctx.register_parquet("t", path)
        df = ctx.sql(sql)
        t0 = time.perf_counter()
        indexed_table = df.collect()
        indexed_time = time.perf_counter() - t0
        indexed_keys = _extract_keys(indexed_table, args.id_column)
        recall = len(set(map(str, plain_keys)) & set(map(str, indexed_keys))) / max(
            len(plain_keys), 1
        )
        print(f"Query time (with index): {indexed_time:.3f}s, "
              f"rows={indexed_table.num_rows}")
        print(f"Recall@{args.k}: {recall * 100:.2f}%")
        results[f"{label}_query_s"] = indexed_time
        results[f"{label}_recall"] = recall
        if args.metrics:
            print("--- Metrics ---")
            print(tree_render(df.physical_plan()))
    return results


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--path")
    parser.add_argument("--vector-column", default="embedding")
    parser.add_argument("--id-column", default="id")
    parser.add_argument(
        "--build-mode", choices=["inplace", "rewrite", "both"], default="inplace"
    )
    parser.add_argument("--nprobe", type=int, default=DEFAULT_NPROBE)
    parser.add_argument("--max-candidates", type=int, default=None)
    parser.add_argument("--n-clusters", type=int, default=None)
    parser.add_argument("--k", type=int, default=DEFAULT_K)
    parser.add_argument("--query-row", type=int, default=None)
    parser.add_argument("--metrics", action="store_true")
    parser.add_argument("--rows", type=int, default=DEFAULT_ROWS)
    parser.add_argument("--dim", type=int, default=DEFAULT_DIM)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    run(parser.parse_args(argv))


if __name__ == "__main__":
    main()
