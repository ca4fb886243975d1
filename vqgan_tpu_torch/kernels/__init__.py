"""Hand-written Hopper kernels: CUDA C++ sources in `csrc/`, built with nvcc at
first use and bound with ctypes. Importing this package builds nothing."""

from .build import CudaKernel, build_all
from .flash_fwd import FLASH_FWD

__all__ = ["CudaKernel", "build_all", "FLASH_FWD", "KERNELS"]

# every kernel of the port, for builds and launch counts
KERNELS = {"flash_fwd": FLASH_FWD}
