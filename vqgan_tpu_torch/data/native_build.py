"""Build the host-side C++ data libraries in `vqgan_tpu_torch/native/`.

Counterpart of vqgan_tpu/data/_native_build.py, with its g++ command
(`-O3 -shared -fPIC -std=c++17 -march=native` plus each library's flags).
Two differences:

- The library is named by a hash of the source, the command and the host
  CPU's identity (its model name and feature flags), and lands in
  `vqgan_tpu_torch/_build/`. A `-march=native` library built on one machine
  can die of SIGILL on another; with the CPU in the name, a library carried
  to another host never matches there and is built anew.
- g++ writes to a temporary file that is renamed into place, so two
  processes that build at once each load a whole library.

Nothing builds at import: the loaders build at their first use.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional

__all__ = ["BUILD_DIR", "NATIVE_SRC", "build_native_lib", "cpu_identity",
           "library_path"]

PACKAGE = Path(__file__).resolve().parent.parent
NATIVE_SRC = PACKAGE / "native"
BUILD_DIR = PACKAGE / "_build"
BASE_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-march=native"]


def cpu_identity() -> str:
    """The host CPU's model name and feature flags from /proc/cpuinfo (what
    `-march=native` compiles for), else what g++ resolves `-march=native`
    to."""
    try:
        keep = {}
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            key, _, value = line.partition(":")
            key = key.strip()
            if key in ("vendor_id", "model name", "flags") and key not in keep:
                keep[key] = value.strip()
        if "flags" in keep:
            return "\n".join(f"{k}={v}" for k, v in sorted(keep.items()))
    except OSError:
        pass
    proc = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                          capture_output=True, text=True)
    return platform.machine() + "\n" + proc.stdout


def _command(src: Path, out: Path, extra_flags: List[str]) -> List[str]:
    return ["g++", *BASE_FLAGS, "-o", str(out), str(src), *extra_flags]


def library_path(src: Path, extra_flags: Optional[List[str]] = None,
                 cpu: Optional[str] = None) -> Path:
    """Where the library of `src` built with `extra_flags` on this CPU (or
    on `cpu`, an identity string) lives: `_build/{stem}-{hash}.so`."""
    h = hashlib.sha256(Path(src).read_bytes())
    # the command with a fixed output name: the name must not feed its hash
    h.update("\0".join(_command(Path(src).name, "OUT",
                                extra_flags or [])).encode())
    h.update((cpu_identity() if cpu is None else cpu).encode())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build_native_lib(src: Path,
                     extra_flags: Optional[List[str]] = None) -> Path:
    """Compile `src` unless its library (`library_path`) exists; returns
    the library's path. Raises on a compile failure."""
    so = library_path(src, extra_flags)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(_command(Path(src), Path(tmp), extra_flags or []),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed building {so.name}: {proc.stderr[-500:]}")
    os.replace(tmp, so)  # atomic: a reader never sees half a library
    return so
