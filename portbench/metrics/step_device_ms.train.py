"""Device milliseconds a training step keeps the card busy: the union of
the traced device intervals in the traced sub-window over its steps."""


def read(record):
    trace = record.trace
    if not trace or not trace.get("steps"):
        return None
    return 1000.0 * trace["busy_s"] / trace["steps"]
