"""Standalone top-k search on the PyTorch port (the counterpart of
``topk_search.py``; mirror of pq-vector examples/topk_search.rs).

    python examples/torch_topk_search.py [--device cpu]
"""

import numpy as np
import torch_common as common

from pqvector_tpu_torch import TopkBuilder

indexed = common.ensure_indexed(common.source_path(), common.indexed_path())
query = common.read_query_vector(indexed, common.DEFAULT_COLUMN, common.query_row())

results = TopkBuilder(indexed, query).k(10).nprobe(8).search()
print(f"top-{len(results)} neighbors of row {common.query_row()}:")
for r in results:
    print(f"  row={r.row_idx:8d}  distance={r.distance:.4f}")

# Batched device search for sustained throughput.
from pqvector_tpu_torch import DeviceIvfSearcher  # noqa: E402

searcher = DeviceIvfSearcher.from_parquet(indexed, device=common.device())
queries = np.stack([query] * 4)
dists, ids = searcher.search(queries, k=5, nprobe=8)
print("batched ids[0]:", ids[0].cpu().tolist())
