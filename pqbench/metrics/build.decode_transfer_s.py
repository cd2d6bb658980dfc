"""Seconds a build spends reading the column and uploading it
(``index/build.py:_upload_column``), to the end of its drain: the program's
stages ``build.decode+transfer`` and ``build.transfer_drain``, mean over the
untraced builds."""

STAGES = ("build.decode+transfer", "build.transfer_drain")


def read(record):
    builds = [b for b in record.get("stages") or [] if all(s in b for s in STAGES)]
    if not builds:
        return None
    return sum(sum(b[s] for s in STAGES) for b in builds) / len(builds)
