"""Build and load the hand-written Hopper kernels (`csrc/*.cu`).

Each `.cu` file becomes one shared library with a plain C interface, built
by nvcc for sm_90a at first use and loaded with ctypes. A library's file name
carries a hash of every source under `csrc/` and of the flags, so an edited
source rebuilds and an unchanged one loads from `_build/` (listed in
.gitignore). `build()` starts one nvcc per source, all at once.

Every C entry point returns `cudaGetLastError()` after its launch;
`check()` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("nlplant_distilled", "env_step", "aero_grouped", "task_step")
# -fmad=false keeps a*b+c as two roundings, as the plain PyTorch versions
# compute it; the division and sqrt stay IEEE (nvcc's default without
# --use_fast_math).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-lineinfo", "-Xptxas", "-v",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin); "
                           "the CUDA kernels are built from csrc/ at first use")
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn.endswith((".cu", ".cuh")):
            h.update(fn.encode())
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"{name}-{_source_hash()}.so")


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every named source that is not built yet, one nvcc process
    each, all started together. Returns {name: seconds} for those built;
    raises with nvcc's output if one fails. nvcc's own report (registers,
    shared memory, spills) is kept in `<library>.log`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(out + ".log", "w", encoding="utf-8") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _LIBS[name] = lib
    return lib


def check(code: int, what: str, lib: ctypes.CDLL) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        lib.np_cuda_error_string.restype = ctypes.c_char_p
        lib.np_cuda_error_string.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({lib.np_cuda_error_string(code).decode()})")
