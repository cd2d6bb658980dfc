"""Seconds a build spends in Lloyd's iterations (``index/kmeans.py:_lloyd``)
to their host read: the program's span ``build.train.lloyd``, recorded in
every build, mean over the builds of the untraced window
(``pqbench/spans.py``). The device work seeding left queued is waited for
here."""

from pqbench import spans


def read(record):
    return spans.per_window_build(record, "build.train.lloyd", "build.train")
