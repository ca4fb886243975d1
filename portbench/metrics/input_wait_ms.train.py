"""Host milliseconds a training step waits for its batch: the time spent
in `data/prefetch.device_prefetch`'s `next()` (the host pool's batch and
the enqueued copy to the device) over the measured window, per step."""


def read(record):
    host = record.host
    if not host.get("steps") or "input_wait_s" not in host:
        return None
    return 1000.0 * host["input_wait_s"] / host["steps"]
