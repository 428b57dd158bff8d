"""Native (C++) host runtime bindings.

The reference's host layer is native C++ (loader load.hpp, CSR
conversion); this package provides native equivalents, exposed over
a plain C ABI and bound with ctypes (no pybind11 dependency):

- ``mm_read(path)``            — fast Matrix Market parse (+symmetric expansion)
- ``coo_to_csr_perm(...)``     — stable counting sort
- ``spgemm_symbolic(...)``     — Gustavson symbolic phase for ``spgemm``

The library is compiled on first use with g++ -O2 and cached next to
this file; every caller has a pure-NumPy fallback, so a missing
toolchain degrades performance, not capability.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host.cpp")
_LIB_PATH = os.path.join(_HERE, "_spmv_host.so")

_lock = threading.Lock()
_lib = None
_tried = False


class _MMResult(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("rows", ctypes.POINTER(ctypes.c_int32)),
        ("cols", ctypes.POINTER(ctypes.c_int32)),
        ("vals", ctypes.POINTER(ctypes.c_double)),
        ("field", ctypes.c_int32),
        ("symmetry", ctypes.c_int32),
    ]


def _build() -> str | None:
    """Compile host.cpp to a shared library; return its path or None."""
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC):
        return _LIB_PATH
    try:
        with tempfile.TemporaryDirectory() as td:
            tmp = os.path.join(td, "_spmv_host.so")
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp],
                check=True, capture_output=True, timeout=240,
            )
            os.replace(tmp, _LIB_PATH)
        return _LIB_PATH
    except (OSError, subprocess.SubprocessError) as e:  # pragma: no cover
        sys.stderr.write(f"spmv_tpu.native: build failed ({e}); using NumPy fallback\n")
        return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("SPMV_TPU_NO_NATIVE"):
            return None
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:  # pragma: no cover
            sys.stderr.write(f"spmv_tpu.native: load failed ({e})\n")
            return None
        lib.spmv_last_error.restype = ctypes.c_char_p
        lib.spmv_free.argtypes = [ctypes.c_void_p]
        lib.spmv_mm_read.argtypes = [ctypes.c_char_p, ctypes.POINTER(_MMResult)]
        lib.spmv_mm_read.restype = ctypes.c_int
        I64 = ctypes.c_int64
        P64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        P32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.spmv_coo_to_csr.argtypes = [I64, I64, P32, P32, P64, P32, P64]
        lib.spmv_coo_to_csr.restype = ctypes.c_int
        PPI32 = ctypes.POINTER(ctypes.POINTER(ctypes.c_int32))
        PPI64 = ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))
        PI64 = ctypes.POINTER(ctypes.c_int64)
        lib.spmv_spgemm_symbolic.argtypes = [
            I64, I64, P64, P64, P64, P64, P64,
            PPI32, PI64, PPI64, PPI64, PPI64, PI64]
        lib.spmv_spgemm_symbolic.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _err(lib) -> str:
    return lib.spmv_last_error().decode(errors="replace")


def mm_read(path: str):
    """Native .mtx parse. Returns (n_rows, n_cols, rows, cols, vals) with
    0-based int32 indices, float64 values, symmetric entries expanded.
    Raises ValueError on malformed files, NotImplementedError when the
    native path can't handle the file (caller falls back to Python)."""
    lib = _load()
    if lib is None:
        raise NotImplementedError("native library unavailable")
    res = _MMResult()
    rc = lib.spmv_mm_read(os.fsencode(path), ctypes.byref(res))
    if rc != 0:
        msg = _err(lib)
        if "supported" in msg:
            raise NotImplementedError(msg)
        raise ValueError(f"{path}: {msg}")
    try:
        n = res.nnz
        rows = np.ctypeslib.as_array(res.rows, shape=(n,)).copy() if n else np.empty(0, np.int32)
        cols = np.ctypeslib.as_array(res.cols, shape=(n,)).copy() if n else np.empty(0, np.int32)
        vals = np.ctypeslib.as_array(res.vals, shape=(n,)).copy() if n else np.empty(0, np.float64)
    finally:
        lib.spmv_free(res.rows)
        lib.spmv_free(res.cols)
        lib.spmv_free(res.vals)
    return int(res.n_rows), int(res.n_cols), rows, cols, vals


def coo_to_csr_perm(n_rows: int, rows: np.ndarray, cols: np.ndarray):
    """Native stable counting sort. Returns (Ap int64, Aj int32, perm int64)
    where perm maps CSR position -> original COO position."""
    lib = _load()
    if lib is None:
        raise NotImplementedError("native library unavailable")
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    nnz = rows.shape[0]
    Ap = np.zeros(n_rows + 1, dtype=np.int64)
    Aj = np.empty(nnz, dtype=np.int32)
    perm = np.empty(nnz, dtype=np.int64)
    rc = lib.spmv_coo_to_csr(n_rows, nnz, rows, cols, Ap, Aj, perm)
    if rc != 0:
        raise ValueError(_err(lib))
    return Ap, Aj, perm


def spgemm_symbolic(n_rows: int, n_cols_b: int, Ap, Aj, Bp, Bj):
    """Native Gustavson symbolic phase (see kernels/spgemm.py).

    Returns (Cp int64, Cj int32, v_ap int64, srcA int64, srcB int64,
    total). Raises NotImplementedError when the native lib is absent.
    """
    lib = _load()
    if lib is None:
        raise NotImplementedError("native library unavailable")
    Ap = np.ascontiguousarray(Ap, np.int64)
    Aj = np.ascontiguousarray(Aj, np.int64)
    Bp = np.ascontiguousarray(Bp, np.int64)
    Bj = np.ascontiguousarray(Bj, np.int64)
    Cp = np.zeros(n_rows + 1, np.int64)
    Cj_p = ctypes.POINTER(ctypes.c_int32)()
    vap_p = ctypes.POINTER(ctypes.c_int64)()
    sA_p = ctypes.POINTER(ctypes.c_int64)()
    sB_p = ctypes.POINTER(ctypes.c_int64)()
    nnzC = ctypes.c_int64(0)
    total = ctypes.c_int64(0)
    rc = lib.spmv_spgemm_symbolic(
        n_rows, n_cols_b, Ap, Aj, Bp, Bj, Cp,
        ctypes.byref(Cj_p), ctypes.byref(nnzC), ctypes.byref(vap_p),
        ctypes.byref(sA_p), ctypes.byref(sB_p), ctypes.byref(total))
    if rc != 0:
        raise ValueError(_err(lib))
    try:
        nc, t = int(nnzC.value), int(total.value)
        Cj = (np.ctypeslib.as_array(Cj_p, shape=(nc,)).copy()
              if nc else np.empty(0, np.int32))
        v_ap = np.ctypeslib.as_array(vap_p, shape=(nc + 1,)).copy()
        srcA = (np.ctypeslib.as_array(sA_p, shape=(t,)).copy()
                if t else np.empty(0, np.int64))
        srcB = (np.ctypeslib.as_array(sB_p, shape=(t,)).copy()
                if t else np.empty(0, np.int64))
    finally:
        for p in (Cj_p, vap_p, sA_p, sB_p):
            lib.spmv_free(p)
    return Cp, Cj, v_ap, srcA, srcB, t
