"""A fixture that waits for the JAX package's native data libraries.

The JAX package builds its decoder and latent-reader libraries with g++
writing the `.so` in place, and each test worker may build them at once
while it collects. A worker whose `dlopen` meets a file that another
worker's g++ is still writing marks the library as failed and keeps
returning None. `jax_native_libs` takes an exclusive lock, and where a
loader returned None it clears that module's cached failure (in this test
process only) and loads again, once a second for up to 60 s. It fails with
the last error if the library never loads where g++ and `jpeglib.h` are
present, and skips where they are missing.
"""

import contextlib
import fcntl
import io
import os
import shutil
import subprocess
import tempfile
import time

import pytest

RETRY_SECONDS = 60


def _toolchain_missing():
    """Why the libraries cannot build here, or None."""
    if shutil.which("g++") is None:
        return "g++ is not installed"
    probe = subprocess.run(["g++", "-E", "-x", "c++", "-"],
                           input="#include <jpeglib.h>\n", text=True,
                           capture_output=True)
    if probe.returncode != 0:
        return "jpeglib.h is not installed"
    return None


def _load_with_retries(module, load):
    """`load()` until it returns a library; the printed error of the last
    attempt if it never does within RETRY_SECONDS."""
    deadline = time.monotonic() + RETRY_SECONDS
    while True:
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            lib = load()
        if lib is not None:
            return None
        if time.monotonic() > deadline:
            return said.getvalue().strip() or "the loader returned None"
        module._lib_cache = None
        module._lib_failed = False
        time.sleep(1.0)


@pytest.fixture(scope="module")
def jax_native_libs():
    from vqgan_tpu.data import native_image, native_loader

    lock_path = os.path.join(tempfile.gettempdir(),
                             "vqgan_tpu_jax_native_libs.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            for module, load in ((native_image, native_image.load_decoder_lib),
                                 (native_loader,
                                  native_loader.load_native_lib)):
                with contextlib.redirect_stdout(io.StringIO()):
                    loaded = load() is not None
                if not loaded:
                    missing = _toolchain_missing()
                    if missing:
                        pytest.skip(f"{module.__name__}: {missing}")
                    error = _load_with_retries(module, load)
                    if error is not None:
                        pytest.fail(f"{module.__name__} never loaded: "
                                    f"{error}")
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
