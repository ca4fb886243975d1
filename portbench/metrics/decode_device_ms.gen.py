"""Device milliseconds of one request's KL-VAE decode: the device time
inside the traced requests' decode ranges (each ends when the images are
on the host) per request."""

from portbench.readers import range_device_seconds


def read(record):
    trace = record.trace
    if not trace or not trace.get("requests"):
        return None
    seconds = range_device_seconds(trace, "decode")
    if not seconds:
        return None
    return 1000.0 * seconds / trace["requests"]
