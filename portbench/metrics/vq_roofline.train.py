"""The nearest-code kernel's share of its roofline in the traced
sub-window, in %."""

from portbench.readers import kernel_roofline


def read(record):
    return kernel_roofline(record, ["vq_nearest"])
