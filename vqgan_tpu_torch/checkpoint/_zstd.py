"""zstd decompression through the system's `libzstd.so.1`, bound with ctypes.

Python has no zstd module; the JAX package's checkpoints compress every
B-tree node, manifest and array chunk with zstd. The library is loaded at
the first call, not at import. Where it is missing the call raises, naming
`libzstd.so.1`: there is no other decoder to fall back on.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

__all__ = ["decompress", "decompress_into", "version"]

LIBRARY = "libzstd.so.1"
# ZSTD_getFrameContentSize's two sentinels
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        try:
            lib = ctypes.CDLL(LIBRARY)
        except OSError as e:
            raise RuntimeError(
                f"{LIBRARY} (the zstd library) is needed to read Orbax "
                f"checkpoints and could not be loaded: {e}") from e
        lib.ZSTD_versionNumber.argtypes = []
        lib.ZSTD_versionNumber.restype = ctypes.c_uint
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_void_p,
                                                 ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                        ctypes.c_void_p, ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def version() -> str:
    """libzstd's version, e.g. "1.5.5"."""
    n = _library().ZSTD_versionNumber()
    return f"{n // 10000}.{n // 100 % 100}.{n % 100}"


def _run(lib, dst, capacity: int, src: bytes) -> int:
    """ZSTD_decompress into `dst` (a writable buffer of `capacity` bytes);
    the decompressed length, or -1 where `capacity` was too small."""
    out = lib.ZSTD_decompress(dst, capacity, src, len(src))
    if lib.ZSTD_isError(out):
        name = lib.ZSTD_getErrorName(out).decode()
        if "too small" in name:
            return -1
        raise ValueError(f"zstd: {name}")
    return out


def decompress_into(src: bytes, dst: np.ndarray) -> None:
    """Decompress one frame whose content is exactly `dst`'s bytes into the
    C-contiguous `dst`. A zarr chunk's frame does not state its size (the
    JAX package's writer streams it); the .zarray gives it, and a frame
    that decodes to more or fewer bytes raises."""
    if not dst.flags.c_contiguous or not dst.flags.writeable:
        raise ValueError("zstd: the destination must be C-contiguous and "
                         "writeable")
    lib = _library()
    size = lib.ZSTD_getFrameContentSize(src, len(src))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame")
    if size not in (_CONTENTSIZE_UNKNOWN, dst.nbytes):
        raise ValueError(f"zstd: the frame holds {size} bytes, "
                         f"{dst.nbytes} expected")
    got = _run(lib, dst.ctypes.data, dst.nbytes, src)
    if got < 0:
        raise ValueError(f"zstd: the frame holds more than the {dst.nbytes} "
                         f"bytes expected")
    if got != dst.nbytes:
        raise ValueError(f"zstd: the frame holds {got} bytes, {dst.nbytes} "
                         f"expected")


def decompress(src: bytes, limit: int) -> bytes:
    """Decompress one frame of at most `limit` bytes. A frame that does not
    state its size (as OCDBT's nodes) is decoded into a buffer that doubles
    until it fits or passes `limit`."""
    lib = _library()
    size = lib.ZSTD_getFrameContentSize(src, len(src))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame")
    if size != _CONTENTSIZE_UNKNOWN and size > limit:
        raise ValueError(f"zstd: the frame holds {size} bytes, over the "
                         f"limit of {limit}")
    capacity = (size if size != _CONTENTSIZE_UNKNOWN
                else min(limit, max(1 << 16, 8 * len(src))))
    while True:
        buf = ctypes.create_string_buffer(max(capacity, 1))
        got = _run(lib, buf, capacity, src)
        if got >= 0:
            return buf.raw[:got]
        if capacity >= limit:
            raise ValueError(f"zstd: the frame decodes to over {limit} bytes")
        capacity = min(limit, 2 * capacity)
