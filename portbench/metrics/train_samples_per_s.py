"""Training samples (the global batch's images) completed per
second of the measured window; the window ends with the device
synchronised after the last block."""


def read(record):
    host = record.host
    if "samples" not in host or not host["window_s"]:
        return None
    return host["samples"] / host["window_s"]
