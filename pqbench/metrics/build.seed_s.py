"""Seconds a build spends in k-means++ seeding
(``index/kmeans.py:_kmeans_pp_init``): the program's span
``build.train.seed``, host time with no sync added, recorded in every build,
mean over the builds of the untraced window (``pqbench/spans.py``)."""

from pqbench import spans


def read(record):
    return spans.per_window_build(record, "build.train.seed", "build.train")
