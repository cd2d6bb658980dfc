"""Rows K3 fetched a traced search call, over the layout's rows, %: the
program's ``k3.chunks`` counter ((block, chunk) pairs K3 scored, added up on
the device) times the kernels' chunk rows, over the ``rows`` of the calls
that launched K3 (their ``search`` spans). Each block of 128 queries reads
its own probed union, so a batch of 32 blocks counts a row it shares up to
32 times. A program without K3's counter gives None."""

import sys

from pqbench import spans


def read(record):
    st = spans.store()
    score_tile = sys.modules.get(spans.PROGRAM + ".kernels.score_tile")
    if not st or score_tile is None or "k3.chunks" not in st["counters"]:
        return None
    by_id = {s["id"]: s for s in st["spans"]}
    base = 0
    for s in st["spans"]:
        launches = s["counters"].get("k3.launches", 0)
        call = spans._call_of(s, by_id) if launches else None
        if call is not None:
            base += launches * call["counters"].get("rows", 0)
    if base <= 0:
        return None
    return 100.0 * st["counters"]["k3.chunks"] * score_tile.CHUNK_ROWS / base
