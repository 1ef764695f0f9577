"""Lazy g++ build + cache for native components.

The reference ships prebuilt native binaries (bazel); we compile on first
use instead — a few hundred ms once per machine — and cache the .so keyed
by source mtime, so edits rebuild automatically.  The port's copy of
``ray_tpu/native/build.py``: its libraries land in
``ray_tpu_torch/_build/native/``, apart from the reference's build
directory, so the two packages never load each other's builds.  Every
library a process loads is an event of the program ledger's
``kernels.build`` (``telemetry/device.py``), with the compiler's time.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
import time
from typing import Optional

logger = logging.getLogger(__name__)

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_SRC_DIR), "_build", "native")
_lock = threading.Lock()
_cache: dict = {}


def _compile(out: str, srcs: list, flags: list, timeout: float) -> str:
    """mtime-cached g++ compile-and-swap shared by every build target.
    Raises RuntimeError on any failure mode (missing compiler included)."""
    if os.path.exists(out):
        out_mtime = os.path.getmtime(out)
        if all(os.path.getmtime(s) <= out_mtime for s in srcs):
            return out
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = out + ".tmp.%d" % os.getpid()
    cmd = ["g++", *flags, "-o", tmp, *srcs, "-lpthread"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native build failed to run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"native build of {os.path.basename(out)} failed:\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: concurrent builds race benignly
    return out


def build_extension(name: str, sources: list, extra_flags: list = ()) -> str:
    """Compile sources into _build/lib<name>.so; returns the path.

    Rebuilds when any source is newer than the cached .so.  Raises
    RuntimeError if the compiler fails.
    """
    return _compile(
        os.path.join(_BUILD_DIR, f"lib{name}.so"),
        [os.path.join(_SRC_DIR, s) for s in sources],
        ["-O2", "-g", "-std=c++17", "-shared", "-fPIC", *extra_flags],
        timeout=120)


def build_sanitized_selftest() -> str:
    """Build the ASAN+UBSAN self-test binary (reference: the C++ tests'
    bazel asan/tsan configs in .bazelrc); returns the binary path.
    Rebuilds when any native source is newer."""
    sources = ["selftest.cc", "shm_arena.cc", "shm_channel.cc", "sched.cc"]
    return _compile(
        os.path.join(_BUILD_DIR, "native_selftest_san"),
        [os.path.join(_SRC_DIR, s) for s in sources],
        ["-std=c++17", "-g", "-O1", "-fno-omit-frame-pointer",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all"],
        timeout=300)


def load_library(name: str, sources: list) -> ctypes.CDLL:
    """Build (if needed) and dlopen a native component; cached per-process."""
    with _lock:
        if name in _cache:
            return _cache[name]
        t0 = time.perf_counter()
        before = _mtime(os.path.join(_BUILD_DIR, f"lib{name}.so"))
        path = build_extension(name, sources)
        lib = ctypes.CDLL(path)
        _cache[name] = lib
        from ray_tpu_torch.telemetry import device as _devtel

        _devtel.get_ledger().record_build(
            f"native/{name}", time.perf_counter() - t0, "g++",
            cached=_mtime(path) == before)
        return lib


def _mtime(path: str) -> Optional[float]:
    return os.path.getmtime(path) if os.path.exists(path) else None


if __name__ == "__main__":
    import sys

    if "--sanitize" in sys.argv:
        path = build_sanitized_selftest()
        print(path)
        rc = subprocess.run([path, "/tmp"]).returncode
        sys.exit(rc)
    print("usage: python -m ray_tpu_torch.native.build --sanitize")
