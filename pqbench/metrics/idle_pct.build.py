"""Share of the traced window of the builds in which no kernel, copy
or set ran on the device, %."""


def read(record):
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
