"""VectorIndexScanExec: leaf operator emitting candidate (path, row_id) rows.

Component #16 in SURVEY.md §2 (pq-vector src/df_vector/index_exec.rs).
Per file: footer read through the object store, pq-vector KV metadata parse,
**column-name match enforced** (index_exec.rs:123-129), offset sanity check
(:130-135), payload range read + decode, dim check (:152-158), probe of the
nprobe nearest clusters. Output schema: ``pq_vector_object_path: utf8``,
``pq_vector_row_id: uint32`` (:59-62). Metrics: ``files_scanned``,
``candidate_rows`` (:283-300).
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa

from ..errors import ExecutionError, PlanError
from ..io.embed import (
    PQ_VECTOR_METRIC_KEY,
    parse_index_metadata,
    read_index_from_payload,
)
from ..io.thrift import read_key_value_metadata
from .access import ScanFile
from .options import VectorTopKOptions
from .physical import ExecutionPlan, TaskContext, cache_put, file_cache_key

INDEX_PATH_COL = "pq_vector_object_path"
INDEX_ROW_ID_COL = "pq_vector_row_id"

_SCHEMA = pa.schema(
    [
        pa.field(INDEX_PATH_COL, pa.utf8(), nullable=False),
        pa.field(INDEX_ROW_ID_COL, pa.uint32(), nullable=False),
    ]
)

_FOOTER_SIZE = 8


class VectorIndexScanExec(ExecutionPlan):
    name = "VectorIndexScanExec"
    tree_name = "vector_index_scan"

    def __init__(
        self,
        files: list[ScanFile],
        vector_column: str,
        query: np.ndarray,
        options: VectorTopKOptions,
    ):
        super().__init__()
        self.files = files
        self.vector_column = vector_column
        self.query = np.asarray(query, dtype=np.float32).reshape(-1)
        self.options = options
        self._files_scanned = self.metrics.counter("files_scanned")
        self._candidate_rows = self.metrics.counter("candidate_rows")

    def schema(self) -> pa.Schema:
        return _SCHEMA

    def execute(self, context: TaskContext) -> pa.Table:
        store = context.object_store
        paths: list[str] = []
        row_ids: list[np.ndarray] = []
        with self.metrics.elapsed_compute.timer():
            if len(self.files) > 1 and not store.is_local():
                # Remote stores: footer/payload reads of different files
                # are independent round trips — overlap them (the
                # reference's async object_store does the same implicitly,
                # index_exec.rs:96-143).
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(
                    max_workers=min(8, len(self.files))
                ) as pool:
                    per_file = list(
                        pool.map(
                            lambda f: self._scan_file(
                                store, f, context.index_cache
                            ),
                            self.files,
                        )
                    )
            else:
                per_file = [
                    self._scan_file(store, f, context.index_cache)
                    for f in self.files
                ]
            for file, candidates in zip(self.files, per_file):
                paths.extend([file.object_path] * candidates.size)
                row_ids.append(candidates)

        self._files_scanned.add(len(self.files))
        all_rows = (
            np.concatenate(row_ids) if row_ids else np.empty(0, dtype=np.uint32)
        )
        self._candidate_rows.add(int(all_rows.size))
        table = pa.Table.from_arrays(
            [
                pa.array(paths, pa.utf8()),
                pa.array(all_rows.astype(np.uint32), pa.uint32()),
            ],
            schema=_SCHEMA,
        )
        self.metrics.output_rows.add(table.num_rows)
        return table

    def _scan_file(
        self, store, file: ScanFile, index_cache: dict | None = None
    ) -> np.ndarray:
        path = file.object_path
        file_size = file.file_size
        # Cache identity includes (size, mtime_ns) so a same-size in-place
        # rewrite invalidates the decoded index; for non-local stores the
        # stat fails and the key degrades to size-only (matching the
        # store-provided file_size above).
        cache_key = (path, file_size, file_cache_key(path))
        cached = (
            index_cache.get(cache_key) if index_cache is not None else None
        )
        if cached is not None:
            index, embedding_column, metric = cached
            return self._probe(index, embedding_column, metric, path)
        tail = store.get_range(path, file_size - _FOOTER_SIZE, file_size)
        if tail[4:] == b"PARE":
            # Match the precise io-path error (parquet.rs:556-558 rejects
            # encrypted footers explicitly rather than as "not parquet").
            raise ExecutionError(
                f"Parquet file '{path}' has an encrypted footer; "
                "pq_vector indexes require plaintext footers"
            )
        if tail[4:] != b"PAR1":
            raise ExecutionError(f"'{path}' is not a valid parquet file")
        metadata_len = int.from_bytes(tail[:4], "little")
        meta_start = file_size - _FOOTER_SIZE - metadata_len
        if meta_start < 0:
            raise ExecutionError(f"Parquet footer length exceeds size of '{path}'")
        metadata = store.get_range(path, meta_start, file_size - _FOOTER_SIZE)

        try:
            kv = read_key_value_metadata(metadata)
            parsed = parse_index_metadata(kv)
        except Exception as exc:
            raise ExecutionError(
                f"Failed to parse pq-vector metadata from '{path}': {exc}"
            ) from exc
        if parsed is None:
            raise ExecutionError(f"Missing pq-vector index metadata in '{path}'")
        offset, embedding_column = parsed

        if str(embedding_column) != self.vector_column:
            raise ExecutionError(
                f"IVF index column mismatch: expected '{self.vector_column}', "
                f"found '{embedding_column}'"
            )
        if offset >= file_size:
            raise ExecutionError(
                f"Invalid pq-vector index offset {offset} for '{path}' with "
                f"size {file_size}"
            )

        payload = store.get_range(path, offset, file_size)
        try:
            index, _ = read_index_from_payload(payload, embedding_column)
        except Exception as exc:
            raise ExecutionError(
                f"Failed to decode pq-vector payload from '{path}': {exc}"
            ) from exc

        metric = dict(kv).get(PQ_VECTOR_METRIC_KEY, "l2")
        if index_cache is not None:
            cache_put(
                index_cache,
                cache_key,
                (index, str(embedding_column), metric),
            )
        return self._probe(index, str(embedding_column), metric, path)

    def _probe(self, index, embedding_column: str, metric: str, path: str):
        """Validate + probe a (possibly cached) decoded index."""
        if embedding_column != self.vector_column:
            raise ExecutionError(
                f"IVF index column mismatch: expected '{self.vector_column}', "
                f"found '{embedding_column}'"
            )
        if index.dim != self.query.size:
            raise PlanError(
                f"Query dimension mismatch: expected {index.dim}, got "
                f"{self.query.size}"
            )
        query = self.query
        if metric == "cosine":
            # Cosine-trained centroids live on the unit sphere (extension key,
            # io/embed.py); probing with the raw query would pick the wrong
            # clusters. The TopK scoring itself stays euclidean — that is
            # what SQL's array_distance means.
            from ..index.metrics import normalize_vector

            query = normalize_vector(query)
        return index.candidate_rows(query, self.options.nprobe)

    def tree_lines(self) -> list[str]:
        return [
            f"files={len(self.files)}",
            f"files_scanned={self.metrics.value('files_scanned')}",
            f"candidate_rows={self.metrics.value('candidate_rows')}",
        ]

    def display_line(self) -> str:
        return "VectorIndexScanExec"
