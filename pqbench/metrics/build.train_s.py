"""Seconds a build spends in k-means (``index/kmeans.py``): the program's stage
``build.train``, mean over the untraced builds."""

STAGE = "build.train"


def read(record):
    builds = [b[STAGE] for b in record.get("stages") or [] if STAGE in b]
    if not builds:
        return None
    return sum(builds) / len(builds)
