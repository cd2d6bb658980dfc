"""Dictionary-encoded data pages of the vector column a traced SQL query
decodes page-exact (``io/pages.py``'s ``PageSelectiveReader``: the
``dict_pages`` counter of the query's root ``sql`` span; they are also
among ``sql.pages_read``), mean over the traced queries. A program whose
page reader keeps no such counter gives None."""

from pqbench.drivers import sql_loop


def read(record):
    found = sql_loop._sql_spans()
    if found is None or not any("dict_pages" in r["counters"] for r in found[0].values()):
        return None
    return sql_loop.read_per_query("dict_pages")
