"""Seconds the program spent capturing the cell's CUDA graphs (the sum of
`capture_seconds` of the trainer's `graph_stats()` or the sampler's
`ChainGraphs.stats()`): part of set-up."""


def read(record):
    value = record.counters.get("graph_capture_s")
    return value if value else None
