"""SQL vector search on the PyTorch port (the counterpart of
``sql_query.py``; mirror of pq-vector examples/datafusion_sql.rs).

    python examples/torch_sql_query.py [--device cpu]
"""

import torch_common as common

from pqvector_tpu_torch.engine import Session, VectorTopKOptions, tree_render

indexed = common.ensure_indexed(common.source_path(), common.indexed_path())
query = common.read_query_vector(indexed, common.DEFAULT_COLUMN, common.query_row())
literal = "[" + ", ".join(f"{v}" for v in query) + "]"

session = Session(VectorTopKOptions(nprobe=8, max_candidates=4096), device=common.device())
session.register_parquet("t", indexed)

sql = (
    f"SELECT id, title FROM t "
    f"ORDER BY array_distance({common.DEFAULT_COLUMN}, {literal}) LIMIT 5"
)
print(sql[:120] + ("..." if len(sql) > 120 else ""))
df = session.sql(sql)
table = df.collect()
print(table.to_pandas())
print()
print(tree_render(df.physical_plan()))
