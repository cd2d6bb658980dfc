"""Device-resident serving on the PyTorch port (the counterpart of
``serving.py``, an extension beyond the reference's examples).

Shows the serving surface:
* the full-scan mode (``mode="scan"``: candidates from an over-fetch of
  every row instead of probe selection, winners re-scored exactly),
* the chained loop API used for honest throughput measurement,
* SQL top-k served from the resident searcher (Session.device_searcher).

    python examples/torch_serving.py [--device cpu]
"""

import numpy as np
import torch_common as common

from pqvector_tpu_torch import DeviceIvfSearcher
from pqvector_tpu_torch.engine.options import VectorTopKOptions
from pqvector_tpu_torch.engine.session import Session

indexed = common.ensure_indexed(common.source_path(), common.indexed_path())
query = common.read_query_vector(indexed, common.DEFAULT_COLUMN, common.query_row())
queries = np.stack([query] * 8)
device = common.device()

searcher = DeviceIvfSearcher.from_parquet(indexed, device=device)

# Exact-selection IVF (auto picks the measured-best kernel for the layout).
d_ivf, ids_ivf = searcher.search(queries, k=5, nprobe=8)
print("ivf ids[0]: ", ids_ivf[0].cpu().tolist())

# Full scan: nprobe-free serving; winners re-scored exactly.
d_scan, ids_scan = searcher.search(queries, k=5, nprobe=8, mode="scan")
print("scan ids[0]:", ids_scan[0].cpu().tolist())

# Chained-loop serving call: `reps` batches in one call.
d_loop, ids_loop = searcher.search_loop(queries, k=5, nprobe=8, reps=4, mode="scan")
print("loop ids[0]:", ids_loop[0].cpu().tolist())

# SQL top-k served from the resident searcher: identical results to the
# host path (probe -> candidate pages -> filter -> top-k), tiny I/O.
session = Session(VectorTopKOptions(nprobe=8), device=device)
session.register_parquet("t", indexed)
session.device_searcher("t")  # cache -> resident serving active
vec = ", ".join(f"{v:.6f}" for v in query)
df = session.sql(
    f"SELECT id FROM t ORDER BY array_distance({common.DEFAULT_COLUMN}, [{vec}]) LIMIT 5"
)
print("sql ids:    ", df.collect().column("id").to_pylist())

# Autotuned serving plan: calibrate (mode, nprobe) once against a query
# sample for a recall target, then serve the measured winner.
from pqvector_tpu_torch.query import autotune  # noqa: E402

report = autotune(searcher, queries, k=5, recall_target=0.9,
                  modes=("masked", "scan"), reps=2, budget_s=1.0)
if report.best:
    print(f"autotune: mode={report.best.mode} nprobe={report.best.nprobe} "
          f"recall={report.best.recall:.3f}")

# Recall knob: a SPILLED resident layout duplicates boundary rows into
# their runner-up cluster (query/spill.py), lifting probe recall at the
# same nprobe; the probed modes' residual loss is exactly those rows.
spilled = Session(VectorTopKOptions(nprobe=8), device=device)
spilled.register_parquet("t", indexed)
spilled.device_searcher("t", spill=0.2)
df_sp = spilled.sql(
    f"SELECT id FROM t ORDER BY array_distance({common.DEFAULT_COLUMN}, [{vec}]) LIMIT 5"
)
print("spilled ids:", df_sp.collect().column("id").to_pylist())
