"""The flash forward kernel's share of its roofline in the traced
sub-window, in %: least time of its counted launches (frozen formulas,
`portbench/work.py`) over its traced device time."""

from portbench.readers import kernel_roofline


def read(record):
    return kernel_roofline(record, ["flash_fwd"])
