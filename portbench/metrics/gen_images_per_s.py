"""Decoded images completed per second of the measured window: every
request's images are on the host before the next request is sent."""


def read(record):
    host = record.host
    if "images" not in host or not host["window_s"]:
        return None
    return host["images"] / host["window_s"]
