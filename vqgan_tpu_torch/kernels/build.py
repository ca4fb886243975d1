"""Build the hand-written CUDA kernels in `csrc/` and load them with ctypes.

Each source compiles with `nvcc` into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds). Libraries land in
`vqgan_tpu_torch/_build/`, named by the hash of the source and of every
header beside it (`csrc/*.cuh`), so an edited source or header builds anew
at its next use and a stale library is never loaded.
`build_all` starts one `nvcc` per source at once; kernels whose entry points
share a source share its library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["CudaKernel", "build_all", "nvcc_path", "raise_on_error"]

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]
# what the tensor-core entry points return, launching nothing, when an
# input row does not start on 16 bytes (`kMisaligned` in csrc/flash_tc.cuh)
_MISALIGNED = -1


def raise_on_error(name: str, err: int, *inputs: torch.Tensor) -> None:
    """Raise unless `err`, an entry point's return code, says launched."""
    if err == _MISALIGNED:
        raise ValueError(
            f"{name}: every row of every input must start on a 16-byte "
            f"boundary, got bases {[t.data_ptr() % 16 for t in inputs]} "
            f"bytes past 16 and strides {[t.stride() for t in inputs]}")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def nvcc_path() -> str:
    """The CUDA compiler: `nvcc` on PATH, else under CUDA_HOME or
    /usr/local/cuda. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


class CudaKernel:
    """One kernel source in `csrc/`, its C entry point and a launch count.

    `launches` is a plain integer that the kernel's wrapper raises by one at
    each launch, and only there (`count`); `launches_by_shape` splits it by
    the shapes launched. Callers reset both to count a run.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.launches_by_shape = {}
        self.build_log = ""
        self._fn = None

    def count(self, shape) -> None:
        self.launches += 1
        self.launches_by_shape[shape] = self.launches_by_shape.get(shape, 0) + 1

    @property
    def library_path(self) -> Path:
        """The built library, named by a hash of the source and of every
        header in its directory (a source may include any of them)."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.name.encode())
            h.update(header.read_bytes())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def _compile_command(self, out: Path) -> list:
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def start_build(self):
        """Start nvcc in the background unless the library exists. Returns
        (process, temporary output) or None."""
        if self.library_path.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(self._compile_command(Path(tmp)),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, Path(tmp)

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        log, _ = proc.communicate()
        self.build_log = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed for {self.source.name} "
                f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, self.library_path)  # atomic: no half-written library

    def launch(self, device: torch.device, *args) -> int:
        """Call the C entry point with `args` and then PyTorch's current
        stream on `device`, with `device` current; returns its error code.
        The device switch is skipped when `device` is current already (the
        small main-path shapes are bound by this host time)."""
        fn = self.function()
        if device.index == torch.cuda.current_device():
            return fn(*args, torch.cuda.current_stream().cuda_stream)
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream(device).cuda_stream)

    def function(self):
        """The C entry point, building the library first if needed."""
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library_path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


def build_all(kernels) -> None:
    """Compile every source that is not built yet, one nvcc process per
    source, all at once, then load each kernel. Kernels that share a source
    share its library (and the first one's `build_log`)."""
    started = {}
    for kernel in kernels:
        if kernel.source not in started:
            started[kernel.source] = (kernel, kernel.start_build())
    for kernel, handle in started.values():
        kernel.finish_build(handle)
    for kernel in kernels:
        kernel.function()
