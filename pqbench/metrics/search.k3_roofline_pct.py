"""K3's share of its roofline, %: the least time the traced calls' essential
work takes on the card (``roofline.search_call_work``, ``least_seconds``)
over the device seconds of K3's scan kernel (``stream_masked_kernel``, found
by name among the trace's device ops). None where K3 did not run."""

from pqbench import roofline

KERNEL = "stream_masked_kernel"


def _kernel(name: str) -> str:
    """A device op's kernel name without its namespace and template
    arguments: ``pqv::stream_masked_kernel<...>`` -> ``stream_masked_kernel``."""
    return name.split("<", 1)[0].rsplit("::", 1)[-1]


def read(record):
    trace, work = record.get("trace"), record.get("work")
    peaks = roofline.PEAKS.get(record.get("device_kind"))
    if not trace or not work or not peaks:
        return None
    k3_s = sum(s for name, s in trace["device_ops"] if _kernel(name) == KERNEL)
    if k3_s <= 0:
        return None
    return 100.0 * roofline.least_seconds(work, peaks) / k3_s
