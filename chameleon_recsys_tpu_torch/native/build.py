"""Build the native host libraries (``sknn.cc``, ``chio.cc``) at first use.

The port's copy of ``chameleon_recsys_tpu/native/build.py``'s
``host_arch_digest``, plus the ``g++`` build that the JAX package's
``sknn.py`` and ``loader.py`` each carry.  Each library is built from the
port's own source into the package's gitignored ``_build/`` (the directory
of the CUDA kernels, ``ops/kernels/build.py``), never next to the source,
and is named by the hash of its source and of ``host_arch_digest()``: an
edited source is rebuilt, and a ``-march=native`` binary is never loaded on
a CPU with another instruction set.  ``g++`` writes to a per-process
temporary file that is renamed into place, so concurrent processes (test
workers) see the whole library or none; a lock serialises the threads of one
process (the benchmark thread pool builds at its first predict).  Nothing
here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

_SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = _SRC_DIR.parent / "_build"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
# per source built in this process: the seconds g++ took
build_seconds: Dict[str, float] = {}


@lru_cache(maxsize=1)
def host_arch_digest() -> bytes:
    """Identity of the CPU the compiler targets with -march=native.

    Cached .so files are keyed by this so a binary built on one host is
    never dlopen'd on a host with a different ISA (SIGILL on a shared/NFS
    checkout otherwise).  /proc/cpuinfo's flags line captures the ISA
    extensions; platform.machine() covers the base architecture.
    """
    parts = [platform.machine()]
    cpuinfo = Path("/proc/cpuinfo")
    if cpuinfo.exists():
        for line in cpuinfo.read_text().splitlines():
            if line.lower().startswith(("flags", "features")):
                parts.append(line)
                break
    return "|".join(parts).encode()


def lib_path(name: str) -> Path:
    """``_build/lib<name>-<hash>.so``: the hash of ``<name>.cc`` and of the
    host's instruction set."""
    source = (_SRC_DIR / f"{name}.cc").read_bytes()
    digest = hashlib.sha256(source + host_arch_digest()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load(name: str, libs: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of ``<name>.cc``, built first with ``g++`` (linked
    against ``libs``) when no current one exists.  Raises ``RuntimeError``
    with the compiler's output when it cannot be built, ``OSError`` when it
    cannot be loaded."""
    out = lib_path(name)
    with _lock:
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(_SRC_DIR / f"{name}.cc"),
                   *(f"-l{lib}" for lib in libs)]
            start = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"{name}: g++ not found ({e})") from e
            try:
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"{name}: g++ exited {proc.returncode}\n{proc.stderr}")
                os.replace(tmp, out)  # atomic: a concurrent reader sees all or none
            finally:
                if tmp.exists():
                    tmp.unlink()
            build_seconds[name] = time.perf_counter() - start
    return ctypes.CDLL(str(out))


class NativeLibrary:
    """One native library of the process: built and loaded at the first
    ``get()``, then bound by ``bind(lib)`` (its ``argtypes`` and
    ``restype``).  A failed build is remembered with its reason
    (``error``) and not retried."""

    def __init__(self, name: str, libs: Sequence[str], bind: Callable):
        self.name, self.libs, self.bind = name, tuple(libs), bind
        self.error: Optional[str] = None
        self._lib: Optional[ctypes.CDLL] = None
        self._guard = threading.Lock()

    def get(self) -> Optional[ctypes.CDLL]:
        with self._guard:
            if self._lib is None and self.error is None:
                try:
                    self._lib = self.bind(load(self.name, self.libs))
                except (RuntimeError, OSError) as e:
                    self.error = str(e)
            return self._lib
