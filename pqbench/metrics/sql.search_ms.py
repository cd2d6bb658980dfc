"""Host time a traced SQL query spends in ``sql.search``, whole: the
resident device search (``VectorTopKExec._try_resident`` around
``DeviceIvfSearcher.search(mode="gather")``, whose own ``search`` span nests
under it), each escalation round's, mean over the traced queries' root
``sql`` spans, ms. A program without the spans gives None."""

from pqbench.drivers import sql_loop


def read(record):
    return sql_loop.read_sql_ms("sql.search", whole=True)
