"""Build an IVF index into a Parquet file on a torch device (the
counterpart of ``build_index.py``).

Mirror of pq-vector examples/build_index.rs: builds a new indexed copy
(property-preserving rewrite) and shows the in-place alternative.

    python examples/torch_build_index.py [--device cpu]
"""

import shutil
import time

import torch_common as common

source = common.source_path()
indexed = common.indexed_path()

t0 = time.perf_counter()
common.ensure_indexed(source, indexed)
print(f"indexed copy ready in {time.perf_counter() - t0:.2f}s: {indexed}")

# In-place variant: append the index to a copy of the source file without
# rewriting any data pages.
inplace = source.replace(".parquet", "_inplace.parquet")
shutil.copyfile(source, inplace)
from pqvector_tpu_torch import IndexBuilder, has_pq_vector_index  # noqa: E402

t0 = time.perf_counter()
IndexBuilder(inplace, common.DEFAULT_COLUMN, device=common.device()).build_inplace()
print(
    f"in-place build in {time.perf_counter() - t0:.2f}s; "
    f"has_pq_vector_index={has_pq_vector_index(inplace)}"
)
