"""Rows K4 fetched a traced search call, over the layout's rows, %: the
program's ``k4.chunks`` counter ((block, chunk) pairs K4 scored, added up on
the device) times the kernels' chunk rows, over the ``rows`` of the calls
that launched K4 (``pqbench/spans.py``). Two query blocks a batch each
reading the probed union count it twice."""

from pqbench import spans


def read(record):
    return spans.k4_rows_read_pct()
