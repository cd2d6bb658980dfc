"""Host self time a traced SQL query spends in ``sql.plan``: the parse
(``Session.sql``), ``plan_statement`` and ``optimize`` (the rewrite to
``VectorTopKExec``), mean over the traced queries' root ``sql`` spans, ms.
With ``sql.search_ms``, ``sql.fetch_ms``, ``sql.topk_ms`` and the root's
own self time it sums to the mean ``sql`` span. A program without the spans
gives None."""

from pqbench.drivers import sql_loop


def read(record):
    return sql_loop.read_sql_ms("sql.plan")
