"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ``ctypes``. The
build happens at first use (or up front through :func:`build`, which starts
one ``nvcc`` per source, all at once) into ``clsurvey_torch/_build/``; the
library name carries a hash of its source and flags, so an edited source is
rebuilt and an unchanged one is reused. Nothing here runs at import time.

``LAUNCHES`` counts, per kernel, the launches made by the wrappers in
``ops/preprocess.py`` and ``ops/pool.py``, ``ROUTES`` the pool pair's
launches per route (``pool_fwd_vec``, ``pool_fwd_scalar``, ...), and
``BATCHES`` collects the batch sizes they were launched at;
:func:`reset_launches` clears all three.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
# library -> {C function: argtypes}; every function returns a cudaError_t
SIGNATURES = {
    "preprocess": {
        "clsurvey_normalize_flip": (_P, _P, _P, _L, _I, _I, _I,
                                    _F, _F, _F, _F, _F, _F, _P),
        # an empty kernel, for reading a launch's floor; not counted
        "clsurvey_empty_launch": (_I, _I, _P),
    },
    "pool": {
        # the first design's entries, now the scalar route
        "clsurvey_pool_fwd": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
        "clsurvey_pool_bwd": (_P, _P, _P, _L, _I, _I, _I, _I, _P),
        # the same with the route (0 scalar, 1 vec) chosen by the caller
        "clsurvey_pool_fwd_route": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
        "clsurvey_pool_bwd_route": (_P, _P, _P, _L, _I, _I, _I, _I, _I, _P),
    },
}

LAUNCHES = {"normalize_flip": 0, "pool_fwd": 0, "pool_bwd": 0}
ROUTES = {f"{k}_{r}": 0 for k in ("pool_fwd", "pool_bwd")
          for r in ("vec", "scalar")}
BATCHES: dict[str, set] = {name: set() for name in LAUNCHES}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
        BATCHES[name].clear()
    for name in ROUTES:
        ROUTES[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and PATH): the CUDA "
        "kernels of clsurvey_torch cannot be built")


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    with open(source_path(name), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=None) -> dict[str, str]:
    """Compile the named libraries that are not built yet, one ``nvcc``
    process each, all started together. Returns ``{name: compiler output}``
    (the ``-Xptxas -v`` register and shared-memory report) for the ones it
    compiled; raises with the compiler's output if any build fails."""
    names = list(names or SIGNATURES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if os.path.isfile(out):
            continue
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, source_path(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)  # atomic: other processes see all or none
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{n}:\n{logs[n]}" for n in failed))
    return logs


def lib(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    with _LOCK:
        if name not in _LIBS:
            build([name])
            handle = ctypes.CDLL(library_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(handle, fn).argtypes = argtypes
                getattr(handle, fn).restype = ctypes.c_int
            _LIBS[name] = handle
        return _LIBS[name]


def record_launch(rc: int, kernel: str, batch: int,
                  route: str | None = None) -> None:
    """Called right after each launch at batch size ``batch`` (on
    ``route``, where the kernel has routes): raise if it returned a CUDA
    error code, else count it."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError_t {rc}")
    LAUNCHES[kernel] += 1
    BATCHES[kernel].add(int(batch))
    if route is not None:
        ROUTES[f"{kernel}_{route}"] += 1
