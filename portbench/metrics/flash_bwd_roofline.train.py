"""The two flash backward kernels' (dQ, dK/dV) share of their roofline
together in the traced sub-window, in %."""

from portbench.readers import kernel_roofline


def read(record):
    return kernel_roofline(record, ["flash_bwd_dq", "flash_bwd_dkv"])
