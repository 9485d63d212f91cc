"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles to a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

The library lands in ``flybody_tpu_torch/_build/`` under a name that
carries a hash of the source and of every ``csrc/*.cuh`` header, so an
edited source or header is rebuilt and a stale library is never loaded.
Nothing is built at import time: a kernel's wrapper calls ``load`` on its
first launch, and ``build_all`` builds every source at once (one nvcc
process per source, all started together).
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
    """Library path of ``csrc/<name>.cu``: the name carries a hash of the
    source and of every header in ``csrc/`` (any of them may be included)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [name + ".cu"] + headers:
        h.update(fname.encode())
        with open(os.path.join(CSRC, fname), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


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


def error_string(code: int, name: str) -> str:
    """CUDA's message for ``code``, asked of the library ``name``."""
    return load(name).fb_cuda_error_string(code).decode()


def kernel_info(name: str, which: int, threads: int,
                smem_bytes: int) -> dict:
    """Registers per thread, static and dynamic shared memory per block
    (bytes), resident blocks per SM, local memory per thread (bytes; 0
    when nothing spills) and, for a kernel launched in thread block
    clusters, the clusters the device holds at once (else 0) of kernel
    ``which`` of library ``name`` at ``threads`` threads and
    ``smem_bytes`` of dynamic shared memory (``cudaFuncGetAttributes``,
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` and
    ``cudaOccupancyMaxActiveClusters``)."""
    fn = load(name).fb_kernel_info
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(which, threads, smem_bytes, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name}: kernel_info({which}) failed: CUDA error "
                           f"{err} ({error_string(err, name)})")
    return dict(regs=out[0], static_smem=out[1], dynamic_smem=out[2],
                blocks_per_sm=out[3], local_bytes=out[4], clusters=out[5])
