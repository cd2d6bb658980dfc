"""Per-tile lists whose head is a candidate, over the list heads the
cross-tile merge tested, %: the program's ``merge.lists`` and
``merge.heads`` counters (the merge kernel adds them up on the device while
a traced call runs), summed over the traced calls. How sparse the merge's
input is: only these lists may be read past their head, and the kernel
skips those whose head is already past its running k-th key. A program
without the counters gives None."""

from pqbench import spans


def read(record):
    st = spans.store()
    if not st:
        return None
    heads = st["counters"].get("merge.heads", 0)
    if heads <= 0:
        return None
    return 100.0 * st["counters"].get("merge.lists", 0) / heads
