"""ctypes binding for the native reference QP solver (native/qp_ref.cpp).

The shared library is compiled on first use (g++, cached next to the
source).  This is the framework's quadprog stand-in: a convergence-
terminated float64 oracle used to certify the batched fixed-iteration
solver in tests and offline parity studies.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SRC = os.path.join(_NATIVE_DIR, "qp_ref.cpp")
_LIB = os.path.join(_NATIVE_DIR, "libqpref.so")

_lib = None


def _build() -> None:
    # build to a private temp name, then atomically publish: concurrent
    # processes (pytest-xdist workers) may race to build, and a partially
    # written .so must never be dlopen-able under the public path
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC],
        check=True, capture_output=True)
    os.replace(tmp, _LIB)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if (not os.path.exists(_LIB)
            or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
        _build()
    lib = ctypes.CDLL(_LIB)
    lib.qp_solve_ref.restype = ctypes.c_int
    lib.qp_solve_ref.argtypes = [
        ctypes.c_int, ctypes.c_int,
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
        ctypes.c_int, ctypes.c_double,
    ]
    _lib = lib
    return lib


def solve_qp_ref(P, q, A, b, max_iters: int = 200,
                 tol: float = 1e-10) -> Tuple[np.ndarray, np.ndarray, int]:
    """Solve min 1/2 x'Px + q'x s.t. Ax <= b to high accuracy.

    Returns (x, lam, status); status 0 = converged, 3 = hit max_iters.
    """
    lib = _load()
    P = np.ascontiguousarray(P, np.float64)
    q = np.ascontiguousarray(q, np.float64)
    A = np.ascontiguousarray(A, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    n, mc = q.shape[0], b.shape[0]
    x = np.zeros(n)
    lam = np.zeros(mc)
    status = lib.qp_solve_ref(n, mc, P, q, A, b, x, lam, max_iters, tol)
    return x, lam, status


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False
