"""Hand-written Hopper kernels: CUDA C++ sources in `csrc/`, built with nvcc at
first use and bound with ctypes. Importing this package builds nothing."""

from .build import CudaKernel, build_all
from .flash_bwd import FLASH_BWD_DKV, FLASH_BWD_DQ
from .flash_fwd import FLASH_FWD
from .vq import VQ_NEAREST

__all__ = ["CudaKernel", "build_all", "FLASH_FWD", "FLASH_BWD_DQ",
           "FLASH_BWD_DKV", "VQ_NEAREST", "KERNELS"]

# every kernel of the port, for builds and launch counts
KERNELS = {"flash_fwd": FLASH_FWD, "flash_bwd_dq": FLASH_BWD_DQ,
           "flash_bwd_dkv": FLASH_BWD_DKV, "vq_nearest": VQ_NEAREST}
