"""Seconds a build spends in the payload's append (``io/embed.py``): the program's stage
``build.append``, mean over the untraced builds."""

STAGE = "build.append"


def read(record):
    builds = [b[STAGE] for b in record.get("stages") or [] if STAGE in b]
    if not builds:
        return None
    return sum(builds) / len(builds)
