"""The search call's share of its roofline, %: the least time its essential
work takes on the card (``roofline.search_call_work``, ``least_seconds``)
over the device-busy time of the traced calls."""

from pqbench import roofline


def read(record):
    trace, work = record.get("trace"), record.get("work")
    peaks = roofline.PEAKS.get(record.get("device_kind"))
    if not trace or not work or not peaks or trace["busy_s"] <= 0:
        return None
    return 100.0 * roofline.least_seconds(work, peaks) / trace["busy_s"]
