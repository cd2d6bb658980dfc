"""Mean host time of a search call, ms: the benchmark's own span from the
call's entry to its return, before the sync, over the untraced calls."""


def read(record):
    spans = record.get("host_s")
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
