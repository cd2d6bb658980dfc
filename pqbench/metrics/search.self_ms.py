"""Host self time a traced search call spends in the call's own span, ``search``, less its children: the route, ``_tile_cluster_table``, the square roots and ``_map_ids`` (``query/device.py``): the program's
spans (``pqbench/spans.py``), mean over the traced calls, ms. The six
``search.*_ms`` metrics sum to the mean of the call's span."""

from pqbench import spans


def read(record):
    return spans.search_self_ms("search")
