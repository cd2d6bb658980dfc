"""Data pages of the vector column a traced SQL query reads and decodes
(``io/pages.py``'s ``PageSelectiveReader``: the ``pages`` counter of the
query's root ``sql`` span), mean over the traced queries. A program without
the counter gives None."""

from pqbench.drivers import sql_loop


def read(record):
    return sql_loop.read_per_query("pages")
