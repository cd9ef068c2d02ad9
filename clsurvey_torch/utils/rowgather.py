"""ctypes binding of the native threaded row-gather (``native/rowgather.cpp``)
that feeds the streamed epochs.

Counterpart of ``clsurvey_tpu/utils/rowgather.py``. The library is built at
first use from the source in ``native/``, with ``native/Makefile``'s flags,
into ``clsurvey_torch/_build/`` (the file name carries a hash of the source
and flags, as the CUDA libraries' do); nothing is written into ``native/``.

:func:`gather_rows` computes ``dst[i] = src[idx[i]]`` along axis 0. A
C-contiguous uint8 source with a 1-D index takes the native route: N
threads each copy a span of destination rows, with the interpreter lock
released (ctypes drops it for the call), so a gather thread overlaps the
thread that dispatches the card's work. Every other layout takes numpy's
fancy indexing, as in the JAX package. A failed build also falls back to
numpy; it warns once with the compiler's output, and ``ROUTES`` counts each
call by the route it took, so a caller that needs the native route can
tell.
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings

import numpy as np
import torch

from clsurvey_torch.utils import native

SOURCE = os.path.join(native.NATIVE_DIR, "rowgather.cpp")
# native/Makefile's rowgather rule
CXX_FLAGS = native.MAKEFILE_FLAGS + ("-pthread", "-shared")

ROUTES = {"native": 0, "numpy": 0}

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_BUILD_ERROR: str | None = None


def reset_routes() -> None:
    with _LOCK:
        for name in ROUTES:
            ROUTES[name] = 0


def _load() -> ctypes.CDLL | None:
    """The loaded library, built first if needed; None if the build
    failed (warned once)."""
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is None and _BUILD_ERROR is None:
            try:
                lib = native.load(SOURCE, CXX_FLAGS, "rowgather")
            except RuntimeError as e:
                _BUILD_ERROR = str(e)
                warnings.warn(f"rowgather: every gather takes the numpy "
                              f"route: {_BUILD_ERROR}")
                return None
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.rowgather_u8.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                         i64p, ctypes.c_int64, u8p,
                                         ctypes.c_int]
            lib.rowgather_u8.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def default_threads() -> int:
    return min(8, os.cpu_count() or 1)


def _count(route: str) -> None:
    with _LOCK:
        ROUTES[route] += 1


def gather_rows(src: np.ndarray, idx, n_threads: int | None = None,
                out: torch.Tensor | None = None):
    """``dst[i] = src[idx[i]]`` along axis 0, C-contiguous. Returns a new
    numpy array, or ``out`` filled in place when it is given: a contiguous
    CPU tensor (pinned, for a copy to the card that does not block) of
    ``src``'s dtype and shape ``(len(idx),) + src.shape[1:]``. On the
    native route an index outside ``[0, len(src))`` raises ``IndexError``;
    the numpy route keeps numpy's indexing rules."""
    idx = np.asarray(idx)
    want = idx.shape + src.shape[1:]
    dst = None
    if out is not None:
        if out.device.type != "cpu" or not out.is_contiguous():
            raise ValueError("gather_rows: out must be a contiguous CPU "
                             "tensor")
        dst = out.numpy()
        if dst.shape != want or dst.dtype != src.dtype:
            raise ValueError(f"gather_rows: out is {dst.dtype}{dst.shape}, "
                             f"the gather gives {src.dtype}{want}")
    native = (src.dtype == np.uint8 and idx.ndim == 1 and src.ndim >= 1
              and src.flags["C_CONTIGUOUS"] and len(idx) > 0
              and src.nbytes > 0)
    lib = _load() if native else None
    if lib is None:
        _count("numpy")
        if dst is None:
            return np.ascontiguousarray(src[idx])
        np.take(src, idx, axis=0, out=dst)
        return out
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if dst is None:
        dst = np.empty(want, np.uint8)
    rc = lib.rowgather_u8(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.shape[0],
        src.nbytes // src.shape[0],
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(idx),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        int(n_threads if n_threads is not None else default_threads()))
    if rc != 0:
        raise IndexError("rowgather: index out of range")
    _count("native")
    return dst if out is None else out
