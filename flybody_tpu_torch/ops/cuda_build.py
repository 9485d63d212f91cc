"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles to a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

The library lands in ``flybody_tpu_torch/_build/`` under a name that
carries a hash of the source, so an edited source is rebuilt and a stale
library is never loaded. Nothing is built at import time: a kernel's
wrapper calls ``load`` on its first launch, and ``build_all`` builds every
source at once (one nvcc process per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH = "arch=compute_90a,code=sm_90a"

_loaded: dict = {}


def sources() -> list[str]:
    """Names of the CUDA sources in csrc/ (without the .cu suffix)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def lib_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _command(nvcc: str, name: str, out: str) -> list[str]:
    return [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", out,
            os.path.join(CSRC, name + ".cu")]


def build_all(names=None) -> dict:
    """Compile every source not built yet, all nvcc processes at once.
    Returns {name: compiler log}; raises if any build fails."""
    names = sources() if names is None else list(names)
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        final = lib_path(name)
        if os.path.exists(final):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (final, tmp, subprocess.Popen(
            _command(nvcc, name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (final, tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            os.unlink(tmp)
        else:
            os.replace(tmp, final)   # atomic: readers never see half a file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _loaded.get(name)
    if lib is None:
        path = lib_path(name)
        if not os.path.exists(path):
            build_all([name])
        lib = ctypes.CDLL(path)
        err = lib.fb_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def error_string(code: int, name: str = "solve_rows") -> str:
    return load(name).fb_cuda_error_string(code).decode()
