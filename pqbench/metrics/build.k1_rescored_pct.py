"""Share of the rows K1's screen scored that it left uncertified, which
the FMA form then re-scored (``kernels/assign.py``), %: the counters
``k1.uncertified`` over ``k1.rows`` of the program's ``build.assign`` stage,
which it keeps while tracing is on, summed over the traced builds."""

from pqbench import spans


def read(record):
    rows = unc = 0
    for s in spans.named("build.assign"):
        rows += s["counters"].get("k1.rows", 0)
        unc += s["counters"].get("k1.uncertified", 0)
    return 100.0 * unc / rows if rows else None
