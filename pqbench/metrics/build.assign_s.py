"""Seconds a build spends in the full assignment by K1 (``kernels/assign.py``): the program's stage
``build.assign``, mean over the untraced builds."""

STAGE = "build.assign"


def read(record):
    builds = [b[STAGE] for b in record.get("stages") or [] if STAGE in b]
    if not builds:
        return None
    return sum(builds) / len(builds)
