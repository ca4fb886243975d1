"""ctypes bindings for the native C++ batch assembler
(vqgan_tpu_torch/native/batch_loader.cpp).

Counterpart of vqgan_tpu/data/native_loader.py. `NativeLatentBatcher`
serves fixed-shape latent batches from the `.npy` cache: the headers are
parsed once, at construction; every batch after that is one C call that
fans pread() workers into one contiguous buffer (the GIL released for the
call). The library is built by g++ at first use (`native_build.py`).

Where no compiler is present, `load_native_lib` prints why and returns
None; the LDM trainer then reads through the Python BatchLoader and says
so. The batcher itself has no per-item `np.load` fallback (the JAX
package's): it raises without the library, and a failed read raises
`OSError`, so a trainer that names the native batcher read through it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .native_build import NATIVE_SRC, build_native_lib

__all__ = ["load_native_lib", "NativeLatentBatcher"]

_SRC = NATIVE_SRC / "batch_loader.cpp"
_lib_cache: Optional[ctypes.CDLL] = None
_lib_failed = False


def load_native_lib() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the batch-reader library; None, with
    the reason printed, where it cannot be built or loaded."""
    global _lib_cache, _lib_failed
    if _lib_cache is not None or _lib_failed:
        return _lib_cache
    try:
        lib = ctypes.CDLL(str(build_native_lib(_SRC, ["-lpthread"])))
    except (OSError, RuntimeError) as e:  # no compiler
        print(f"native batch loader unavailable ({e})")
        _lib_failed = True
        return None
    lib.batch_read.restype = ctypes.c_int
    lib.batch_read.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
    ]
    lib.batch_loader_abi_version.restype = ctypes.c_int
    lib.batch_loader_abi_version.argtypes = []
    if lib.batch_loader_abi_version() != 1:
        raise RuntimeError("batch_loader ABI version "
                           f"{lib.batch_loader_abi_version()}, expected 1")
    _lib_cache = lib
    return lib


def _npy_payload_info(path: Path) -> Tuple[int, Tuple[int, ...], np.dtype]:
    """(payload byte offset, shape, dtype) of a .npy file, read by numpy's
    own header parser."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
        else:
            shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
        if fortran:
            raise ValueError(f"{path}: Fortran-order .npy is not supported")
        return f.tell(), shape, dtype


class NativeLatentBatcher:
    """Assemble [B, ...] batches from equal-shape .npy files by index:
    gather(indices) -> array of shape (len(indices), *item_shape)."""

    def __init__(self, paths: Sequence[str | Path], n_threads: int = 8):
        self.paths: List[bytes] = []
        self.offsets: List[int] = []
        self.item_shape: Optional[Tuple[int, ...]] = None
        self.dtype: Optional[np.dtype] = None
        for p in paths:
            off, shape, dtype = _npy_payload_info(Path(p))
            if self.item_shape is None:
                self.item_shape, self.dtype = shape, dtype
            elif (shape, dtype) != (self.item_shape, self.dtype):
                raise ValueError(
                    f"{p}: {shape} {dtype}, the others "
                    f"{self.item_shape} {self.dtype}")
            self.paths.append(str(p).encode())
            self.offsets.append(off)
        self.item_bytes = int(np.prod(self.item_shape) * self.dtype.itemsize)
        self.n_threads = n_threads
        self._lib = load_native_lib()
        if self._lib is None:
            raise RuntimeError("the native batch loader is unavailable")

    def __len__(self):
        return len(self.paths)

    def gather(self, indices: Sequence[int]) -> np.ndarray:
        n = len(indices)
        out = np.empty((n,) + self.item_shape, self.dtype)
        c_paths = (ctypes.c_char_p * n)(*[self.paths[i] for i in indices])
        c_offsets = (ctypes.c_int64 * n)(*[self.offsets[i] for i in indices])
        rc = self._lib.batch_read(
            c_paths, c_offsets, self.item_bytes, n,
            out.ctypes.data_as(ctypes.c_char_p), self.n_threads)
        if rc != 0:
            raise OSError(-rc, f"native batch_read failed (errno {-rc})")
        return out
