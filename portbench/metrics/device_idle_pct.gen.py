"""Share of the traced sub-window in which no device activity ran, in %."""

from portbench.readers import idle_pct


def read(record):
    return idle_pct(record)
