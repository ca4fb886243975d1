"""Device milliseconds of one DDIM step: the device time inside the
traced requests' `generate_samples` ranges (each ends with the device
synchronised) over their DDIM steps."""

from portbench.readers import range_device_seconds


def read(record):
    trace = record.trace
    if not trace or not trace.get("requests"):
        return None
    seconds = range_device_seconds(trace, "generate")
    if not seconds:
        return None
    steps = trace["requests"] * record.host["steps_per_request"]
    return 1000.0 * seconds / steps
