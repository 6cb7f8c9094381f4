"""Build the CUDA sources in ``csrc/`` into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own by ``nvcc`` for Hopper (``sm_90a``) into ``build/torch_kernels/`` at the
root of the checkout, then loaded with ``ctypes``. A library is rebuilt when
it is missing or older than its source. ``build_all`` starts one ``nvcc``
per source at once and waits for all of them, holding an exclusive
``flock`` on ``build/torch_kernels/lock``: processes that start together
(the ranks of a mesh) build once, and the others load what it built. The
lock is released when its process ends, however it ends.
"""

import ctypes
import fcntl
import os
import shutil
import subprocess
import time

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# name -> {"seconds": build time, "log": nvcc's output}, for builds run here
BUILD_LOG = {}
_LIBS = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _paths(name: str):
    return (os.path.join(CSRC_DIR, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def build_all(names=None) -> dict:
    """Compile every named source (default: all of csrc/) that is stale,
    one nvcc process each, all started together. Raises if any fails."""
    if names is None:
        names = sorted(f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu"))
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build(names)


def _build(names) -> dict:
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        if not _stale(name):
            continue
        src, lib = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return BUILD_LOG


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        lib = _LIBS[name] = ctypes.CDLL(_paths(name)[1])
    return lib
