"""Host self time a traced SQL query spends in ``sql.topk``: the predicate
over the fetched rows (``FilterExec``), the distance recompute and top-k
(``VectorTopKExec._topk_from_table``) and the output projection, mean over
the traced queries' root ``sql`` spans, ms. A program without the spans
gives None."""

from pqbench.drivers import sql_loop


def read(record):
    return sql_loop.read_sql_ms("sql.topk")
