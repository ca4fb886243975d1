"""ctypes bindings for the native JPEG batch decoder
(vqgan_tpu_torch/native/image_decoder.cpp).

Counterpart of vqgan_tpu/data/native_image.py. The library is compiled at
first use with g++ against the system libjpeg (`native_build.py`). Where no
compiler or libjpeg is present, `load_decoder_lib` prints why and returns
None, and the callers keep their PIL path, as in the JAX package; the
trainers name the loader they used in their results.

- `decode_jpeg_batch(paths, image_size)`: a contiguous [n, S, S, 3]
  float32 [0, 1] NHWC batch: libjpeg decode, PIL-equivalent triangle
  resample of the shorter side, centre crop, over a thread pool. A file
  that fails to decode raises (the JAX package returns None and its
  callers decode with PIL).
- `NativePipeline`: the C++ ring of `depth` batches decoded ahead by worker
  threads, a per-epoch seeded shuffle, drop-last, each batch's dataset
  indices returned. A decode error raises.
- `NativeBatchLoader`: (images, labels) batches endlessly from the ring.
- `make_batch_loader`: the ring where it applies and pays, else the
  Python `BatchLoader` (whose `get_batch` still decodes with this library).

Every call goes through ctypes `CDLL`, which releases the GIL for the
call's length, so decoding runs while the training thread launches work.
"""

from __future__ import annotations

import ctypes
import os
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from .datasets import BatchLoader, native_decodable
from .native_build import NATIVE_SRC, build_native_lib

__all__ = ["load_decoder_lib", "decode_jpeg_batch", "NativePipeline",
           "NativeBatchLoader", "make_batch_loader", "loader_kind"]

_SRC = NATIVE_SRC / "image_decoder.cpp"
_FLAGS = ["-funroll-loops", "-ljpeg", "-lpthread"]
_lib_cache: Optional[ctypes.CDLL] = None
_lib_failed = False


def load_decoder_lib() -> Optional[ctypes.CDLL]:
    """Compile (if needed) and load the decoder library; None, with the
    reason printed, where it cannot be built or loaded."""
    global _lib_cache, _lib_failed
    if _lib_cache is not None or _lib_failed:
        return _lib_cache
    try:
        lib = ctypes.CDLL(str(build_native_lib(_SRC, _FLAGS)))
    except (OSError, RuntimeError) as e:  # no compiler / no libjpeg
        print(f"native image decoder unavailable ({e}); using PIL fallback")
        _lib_failed = True
        return None
    lib.decode_jpeg_batch.restype = ctypes.c_int
    lib.decode_jpeg_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int,
    ]
    lib.image_decoder_abi_version.restype = ctypes.c_int
    lib.image_decoder_abi_version.argtypes = []
    if lib.image_decoder_abi_version() != 3:
        raise RuntimeError("image_decoder ABI version "
                           f"{lib.image_decoder_abi_version()}, expected 3")
    lib.pipeline_create.restype = ctypes.c_void_p
    lib.pipeline_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_int,
    ]
    lib.pipeline_next.restype = ctypes.c_long
    lib.pipeline_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int)]
    lib.pipeline_destroy.restype = None
    lib.pipeline_destroy.argtypes = [ctypes.c_void_p]
    _lib_cache = lib
    return lib


def decode_jpeg_batch(paths: Sequence[str | Path], image_size: int,
                      n_threads: int = 8) -> Optional[np.ndarray]:
    """[n, S, S, 3] float32 [0, 1] batch; None when the library is
    unavailable or `paths` is empty. Raises when a file fails to decode."""
    lib = load_decoder_lib()
    if lib is None or not paths:
        return None
    n = len(paths)
    out = np.empty((n, image_size, image_size, 3), np.float32)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    rc = lib.decode_jpeg_batch(
        arr, n, image_size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    if rc != 0:
        raise RuntimeError(f"native JPEG decode failed (code {rc}) in a "
                           f"batch of {n} starting {paths[0]}")
    return out


class NativePipeline:
    """Asynchronous C++ image pipeline: worker threads decode whole batches
    ahead of training into a ring of `depth` slots (GIL-free), in a
    deterministic order with a per-epoch seeded reshuffle and drop-last.

        with NativePipeline(paths, image_size=128, batch=8) as pipe:
            if pipe.available:
                batch = pipe.next()   # [batch, S, S, 3] float32 [0, 1]

    `available` is False where the library cannot be built or there are
    fewer paths than a batch."""

    def __init__(self, paths: Sequence[str | Path], image_size: int,
                 batch: int, n_threads: int = 2, depth: int = 3,
                 seed: int = 0, shuffle: bool = True):
        self._handle = None
        self._lib = load_decoder_lib()
        self.image_size, self.batch = image_size, batch
        self.batches_per_epoch = len(paths) // batch if batch else 0
        if self._lib is None or len(paths) < batch:
            return
        self._paths = [str(p).encode() for p in paths]  # kept alive
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = self._lib.pipeline_create(
            arr, len(self._paths), image_size, batch, n_threads, depth,
            seed, int(shuffle))

    @property
    def available(self) -> bool:
        return self._handle is not None

    def next(self, return_indices: bool = False):
        """Blocking: the next [batch, S, S, 3] float32 [0, 1] batch; with
        `return_indices`, also its [batch] int32 dataset indices (the key
        to labels under shuffling). Raises on a decode error."""
        if self._handle is None:
            raise RuntimeError("the native pipeline is not available")
        out = np.empty((self.batch, self.image_size, self.image_size, 3),
                       np.float32)
        idx = np.empty((self.batch,), np.int32)
        seq = self._lib.pipeline_next(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        if seq < 0:
            raise RuntimeError(f"native pipeline decode failed (code {seq})")
        return (out, idx) if return_indices else out

    def close(self) -> None:
        if self._handle is not None:
            self._lib.pipeline_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


class NativeBatchLoader:
    """The Python BatchLoader's counterpart over NativePipeline: (images,
    labels) batches endlessly, decoded GIL-free by C++ worker threads. For
    a dataset with `.items` [(path, label)], `.image_size` and plain [0, 1]
    floats (no ImageNet normalisation); `make_batch_loader` checks that."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, n_threads: int = 2, depth: int = 3):
        paths = [p for p, _ in dataset.items]
        self._labels = np.asarray([lab for _, lab in dataset.items],
                                  np.int32)
        self.batch_size = batch_size
        self._pipe = NativePipeline(
            paths, dataset.image_size, batch_size, n_threads=n_threads,
            depth=depth, seed=seed, shuffle=shuffle)

    @property
    def available(self) -> bool:
        return self._pipe.available

    def __iter__(self):
        while True:
            imgs, idxs = self._pipe.next(return_indices=True)
            yield imgs, self._labels[idxs]

    def close(self) -> None:
        self._pipe.close()


# The async ring wins only when its decode workers get cores of their own:
# the JAX package measured it losing to the synchronous native get_batch on
# a 1-core host (its ring bookkeeping costs a few ms a batch). The ring runs
# n_threads=2 decode workers plus the training thread, so "auto" takes it
# from 3 cores; below that the Python BatchLoader, whose get_batch still
# decodes natively (datasets.ImageFolderDataset.get_batch).
_ASYNC_MIN_CORES = 3


def make_batch_loader(dataset, batch_size: int, shuffle: bool = True,
                      seed: int = 0, native: str | bool = "auto", **kw):
    """The async native ring where it applies (a plain-float all-JPEG
    dataset with `.items`, at least a batch of items, the library present,
    enough cores for its workers; see _ASYNC_MIN_CORES), else the Python
    BatchLoader (repeating epochs), as the JAX package's factory chooses.

    native: True (require the ring: raise where it cannot be had, whatever
    the core count), False (never), "auto" (the measured dispatch; the
    reason for a Python loader is printed)."""
    plain = native_decodable(dataset)  # PNG / BMP datasets keep PIL
    enough_cores = (native is True
                    or (os.cpu_count() or 1) >= _ASYNC_MIN_CORES)
    if native and plain and enough_cores and len(dataset.items) >= batch_size:
        loader = NativeBatchLoader(dataset, batch_size, shuffle=shuffle,
                                   seed=seed)
        if loader.available:
            return loader
        if native is True:
            raise RuntimeError("native input pipeline requested but the "
                               "C++ decoder is unavailable")
        print("input pipeline: the native ring is unavailable; using the "
              "Python BatchLoader")
    elif native is True:
        raise RuntimeError(f"native input pipeline requires a plain-float "
                           f"all-JPEG .items dataset with >= batch_size "
                           f"items; got {type(dataset).__name__}")
    elif native:
        why = ("not a plain-float all-JPEG .items dataset" if not plain
               else f"{os.cpu_count()} cores < {_ASYNC_MIN_CORES}"
               if not enough_cores else "fewer items than a batch")
        print(f"input pipeline: Python BatchLoader ({why})")
    return BatchLoader(dataset, batch_size, shuffle=shuffle, seed=seed,
                       repeat=True, **kw)


def loader_kind(loader) -> str:
    """What reads a trainer's images: "native_ring" (NativeBatchLoader),
    "native_get_batch" (the BatchLoader over a dataset whose `get_batch`
    decodes natively) or "python" (PIL)."""
    if isinstance(loader, NativeBatchLoader):
        return "native_ring"
    dataset = getattr(loader, "dataset", None)
    if (hasattr(dataset, "get_batch") and native_decodable(dataset)
            and load_decoder_lib() is not None):
        return "native_get_batch"
    return "python"
