"""Host self time a traced SQL query spends in ``sql.fetch``: the row-group
counts (``_files_with_candidates``), the candidate budget and access plans,
and the scan's reads (``io/pages.py``: the winners' pages, read and decoded,
and the row groups of the other columns), mean over the traced queries'
root ``sql`` spans, ms. A program without the spans gives None."""

from pqbench.drivers import sql_loop


def read(record):
    return sql_loop.read_sql_ms("sql.fetch")
