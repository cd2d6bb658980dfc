"""Seconds the program takes to lay the index and rows out on the card
(``query/device.py:DeviceIvfSearcher.__init__``): the program's stage
``searcher.init``, recorded in the set-up of every run, mean over the
searchers made."""

from pqbench import spans


def read(record):
    return spans.mean_seconds("searcher.init")
