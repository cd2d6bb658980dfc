"""Worker seconds a build spends on its row groups
(``index/build.py:_upload_column``: read, decode, encode, the wait for the
slot's last copy): the program's ``build.decode`` spans, one a row group on
the decode workers under the ``build.decode+transfer`` stage, summed over
each build of the untraced window and averaged over them
(``pqbench/spans.py``)."""

from pqbench import spans


def read(record):
    return spans.per_window_build(record, "build.decode", "build.decode+transfer")
