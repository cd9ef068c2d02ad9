"""ctypes binding of the native C++ QP solver (``native/qp.cpp``).

Counterpart of ``clsurvey_tpu/ops/qp_native.py``, with the same functions,
float64 numpy in and out. It is host code and the golden reference for
GEM's QP: the port's path on the card is ``ops/qp.py``, which the tests
hold against this module. The library is built at first use from
``native/qp.cpp`` with ``native/Makefile``'s flags into
``clsurvey_torch/_build/`` (``utils/native.py``); nothing is written into
``native/``. Where the build fails, :func:`available` is False and every
solve raises a ``RuntimeError`` that holds the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from clsurvey_torch.utils import native

SOURCE = os.path.join(native.NATIVE_DIR, "qp.cpp")
# native/Makefile's libclsurvey_qp.so rule
CXX_FLAGS = native.MAKEFILE_FLAGS + ("-shared",)

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_BUILD_ERROR: str | None = None

_DPTR = ctypes.POINTER(ctypes.c_double)


def _load() -> ctypes.CDLL | None:
    """The library, built first if needed; None where the build failed
    (tried once a process)."""
    global _LIB, _BUILD_ERROR
    with _LOCK:
        if _LIB is None and _BUILD_ERROR is None:
            try:
                lib = native.load(SOURCE, CXX_FLAGS, "clsurvey_qp")
            except RuntimeError as e:
                _BUILD_ERROR = str(e)
                return None
            lib.solve_bound_qp.argtypes = [_DPTR, _DPTR, _DPTR, ctypes.c_int,
                                           ctypes.c_int, _DPTR]
            lib.solve_bound_qp.restype = ctypes.c_int
            lib.gem_project.argtypes = [_DPTR, _DPTR, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_double,
                                        ctypes.c_double, _DPTR]
            lib.gem_project.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def _lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native QP library unavailable: {_BUILD_ERROR}")
    return lib


def available() -> bool:
    return _load() is not None


def _as_c(arr):
    arr = np.ascontiguousarray(arr, dtype=np.float64)
    return arr, arr.ctypes.data_as(_DPTR)


def solve_bound_qp(P, q, lb, max_iters: int = 0) -> np.ndarray:
    """``argmin 1/2 v'Pv - q'v`` subject to ``v >= lb``, for a symmetric
    positive definite ``P`` (t x t); ``max_iters`` 0 is the solver's own
    limit."""
    lib = _lib()
    P, p_ptr = _as_c(P)
    q, q_ptr = _as_c(q)
    lb, lb_ptr = _as_c(lb)
    t = q.shape[0]
    if P.shape != (t, t) or lb.shape != (t,):
        raise ValueError(f"solve_bound_qp: P {P.shape}, q {q.shape}, lb "
                         f"{lb.shape} do not make one problem")
    out = np.zeros(t, np.float64)
    if lib.solve_bound_qp(p_ptr, q_ptr, lb_ptr, t, max_iters,
                          out.ctypes.data_as(_DPTR)) < 0:
        raise RuntimeError("native QP solve failed (singular system)")
    return out


def gem_project(mem_grads, grad, margin: float,
                eps: float = 1e-3) -> np.ndarray:
    """GEM's projection of ``grad`` (p) onto the cone of the ``t`` memory
    gradients ``mem_grads`` (t x p) with ``margin``, through the dual QP."""
    lib = _lib()
    mem, m_ptr = _as_c(mem_grads)
    g, g_ptr = _as_c(grad)
    t, p = mem.shape
    if g.shape != (p,):
        raise ValueError(f"gem_project: grad {g.shape} against memory "
                         f"gradients {mem.shape}")
    out = np.zeros(p, np.float64)
    if lib.gem_project(m_ptr, g_ptr, t, p, margin, eps,
                       out.ctypes.data_as(_DPTR)) < 0:
        raise RuntimeError("native GEM projection failed")
    return out
