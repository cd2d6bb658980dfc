"""Host self time a traced search call spends in ``search.merge``: ``_final_merge``, the cross-tile sort: the program's
spans (``pqbench/spans.py``), mean over the traced calls, ms. The six
``search.*_ms`` metrics sum to the mean of the call's span."""

from pqbench import spans


def read(record):
    return spans.search_self_ms("search.merge")
