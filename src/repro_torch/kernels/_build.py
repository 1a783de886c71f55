"""Build a kernel library with ``nvcc`` and bind it with ``ctypes``: the
scheme every ``kernels/*/kernel.py`` shares.

A source is compiled for ``sm_90a`` at first use into
``build/repro_torch_kernels/`` at the root of the checkout, under a name
keyed by a hash of the source, the headers it includes from its own
directory (``#include "name.cuh"``) and the flags, so a changed source or
header is rebuilt and an unchanged one is loaded as it is.  The libraries
have a plain C interface; every entry point returns a ``cudaError_t`` and
``mrsch_cuda_error_string`` names it.  Nothing here runs when the module
is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class BuildInfo:
    library: Path
    seconds: float      # time spent compiling; 0.0 when loaded as built
    log: str            # nvcc's output (ptxas register and spill report)


# One lock per library: two kernels build concurrently, one kernel once.
_locks: dict = {}
_locks_guard = threading.Lock()


def _lock(name: str) -> threading.Lock:
    with _locks_guard:
        return _locks.setdefault(name, threading.Lock())


def _nvcc(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError(f"{name}: no CUDA toolkit found (CUDA_HOME is "
                           "unset and nvcc is not on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _key_bytes(source: Path) -> bytes:
    """The source followed by the local headers it includes, in order."""
    src = source.read_bytes()
    return src + b"".join((source.parent / h.decode()).read_bytes()
                          for h in _LOCAL_INCLUDE.findall(src))


def build_library(name: str, source: Path) -> BuildInfo:
    """Compile ``source`` into ``<name>-<hash>.so`` unless already built."""
    key = hashlib.sha256(_key_bytes(source)
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{name}-{key}.so"
    log = lib.with_suffix(".log")
    with _lock(name):
        if lib.exists():
            return BuildInfo(lib, 0.0, log.read_text() if log.exists() else "")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(name), *NVCC_FLAGS, "-o", str(tmp),
                               str(source)], capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{name}: nvcc failed ({proc.returncode}):"
                               f"\n{proc.stdout}\n{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)        # atomic: a concurrent loader sees all or nothing
        return BuildInfo(lib, seconds, proc.stdout + proc.stderr)


def load_library(info: BuildInfo) -> ctypes.CDLL:
    """Load a built library and declare its error-string entry point."""
    lib = ctypes.CDLL(str(info.library))
    lib.mrsch_cuda_error_string.argtypes = [ctypes.c_int]
    lib.mrsch_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, name: str, err: int, where: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if err != 0:
        msg = lib.mrsch_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err}) "
                           f"at {where}")
