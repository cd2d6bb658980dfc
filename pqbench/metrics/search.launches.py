"""Kernels launched per search call, from the device trace of the traced
calls."""


def read(record):
    trace, calls = record.get("trace"), record.get("traced_calls")
    if not trace or not calls or not trace["kernels"]:
        return None
    return trace["kernels"] / calls
