"""ctypes binding for the native graph-text parser (graph_io.cpp) and CSR
builder (csr_build.cpp) — the port's copy of gardenia_tpu/native.

Compiled lazily with g++ on first use into gardenia_tpu_torch/_build/
(not next to the sources); every entry point degrades gracefully to the
NumPy paths in gardenia_tpu_torch.core when the toolchain or the .so is
unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_SRC = os.path.join(_HERE, "graph_io.cpp")
_SO = os.path.join(_BUILD_DIR, "libgtio.so")
_LOCK = threading.Lock()
_LIB = None
_FAILED = False

FMT = {"mtx": 0, "el": 1, "gr": 2, "graph": 3}


def _tmp(path: str) -> str:
    """Per-process temporary name: processes that build at once (test
    workers) must not write one file."""
    return f"{path}.{os.getpid()}.tmp"


def _build() -> Optional[str]:
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", _SRC, "-o", _tmp(_SO)],
            check=True, capture_output=True, timeout=120)
        os.replace(_tmp(_SO), _SO)
        return _SO
    except Exception:
        return None


def _lib():
    global _LIB, _FAILED
    if _LIB is not None or _FAILED:
        return _LIB
    with _LOCK:
        if _LIB is not None or _FAILED:
            return _LIB
        path = _SO if os.path.exists(_SO) and \
            os.path.getmtime(_SO) >= os.path.getmtime(_SRC) else _build()
        if path is None:
            _FAILED = True
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.gt_parse_edges.restype = ctypes.c_int
            lib.gt_parse_edges.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ]
            lib.gt_free.restype = None
            lib.gt_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
        except OSError:
            _FAILED = True
    return _LIB


def available() -> bool:
    return _lib() is not None


def parse_edges(path: str, fmt: str
                ) -> Optional[Tuple[int, int, np.ndarray, np.ndarray,
                                    Optional[np.ndarray]]]:
    """Parse a graph text file natively. Returns (m, n, src, dst, wt)
    or None if the native path is unavailable/failed."""
    lib = _lib()
    if lib is None or fmt not in FMT:
        return None
    m = ctypes.c_int64()
    n = ctypes.c_int64()
    nnz = ctypes.c_int64()
    src_p = ctypes.POINTER(ctypes.c_int32)()
    dst_p = ctypes.POINTER(ctypes.c_int32)()
    wt_p = ctypes.POINTER(ctypes.c_double)()
    rc = lib.gt_parse_edges(path.encode(), FMT[fmt],
                            ctypes.byref(m), ctypes.byref(n),
                            ctypes.byref(nnz), ctypes.byref(src_p),
                            ctypes.byref(dst_p), ctypes.byref(wt_p))
    if rc != 0:
        return None
    k = nnz.value
    try:
        src = np.ctypeslib.as_array(src_p, shape=(k,)).copy()
        dst = np.ctypeslib.as_array(dst_p, shape=(k,)).copy()
        wt = None
        if wt_p:
            wt = np.ctypeslib.as_array(wt_p, shape=(k,)).copy()
    finally:
        lib.gt_free(src_p)
        lib.gt_free(dst_p)
        if wt_p:
            lib.gt_free(wt_p)
    return m.value, n.value, src, dst, wt


# --- native CSR builder (csr_build.cpp) -------------------------------------

_BUILD_SRC = os.path.join(_HERE, "csr_build.cpp")
_BUILD_SO = os.path.join(_BUILD_DIR, "libgtbuild.so")
_BUILD_LIB = None
_BUILD_FAILED = False


def _build_lib():
    global _BUILD_LIB, _BUILD_FAILED
    if _BUILD_LIB is not None or _BUILD_FAILED:
        return _BUILD_LIB
    with _LOCK:
        if _BUILD_LIB is not None or _BUILD_FAILED:
            return _BUILD_LIB
        path = _BUILD_SO
        if not (os.path.exists(path) and
                os.path.getmtime(path) >= os.path.getmtime(_BUILD_SRC)):
            try:
                os.makedirs(_BUILD_DIR, exist_ok=True)
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", _BUILD_SRC,
                     "-o", _tmp(path)],
                    check=True, capture_output=True, timeout=120)
                os.replace(_tmp(path), path)
            except Exception:
                _BUILD_FAILED = True
                return None
        try:
            lib = ctypes.CDLL(path)
            lib.gt_build_csr.restype = ctypes.c_int
            lib.gt_build_csr.argtypes = [
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_double),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ]
            lib.gt_free.restype = None
            lib.gt_free.argtypes = [ctypes.c_void_p]
            _BUILD_LIB = lib
        except OSError:
            _BUILD_FAILED = True
    return _BUILD_LIB


def builder_available() -> bool:
    return _build_lib() is not None


def build_csr(num_rows: int, src: np.ndarray, dst: np.ndarray,
              wt: Optional[np.ndarray] = None, *,
              remove_self_loops: bool = True, dedup: bool = True,
              symmetrize: bool = False
              ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                  Optional[np.ndarray]]]:
    """Clean COO edges into CSR natively (radix sort + dedup + prefix
    sum, csr_build.cpp).  Returns (rowptr i64[m+1], colidx i32, wt or
    None), or None when the native path is unavailable."""
    lib = _build_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    w = None if wt is None else np.ascontiguousarray(wt, np.float64)
    flags = (1 if remove_self_loops else 0) | (2 if dedup else 0) | \
        (4 if symmetrize else 0)
    out_nnz = ctypes.c_int64()
    rp_p = ctypes.POINTER(ctypes.c_int64)()
    ci_p = ctypes.POINTER(ctypes.c_int32)()
    wt_p = ctypes.POINTER(ctypes.c_double)()
    rc = lib.gt_build_csr(
        num_rows, len(src),
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        None if w is None else
        w.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        flags, ctypes.byref(out_nnz), ctypes.byref(rp_p),
        ctypes.byref(ci_p), ctypes.byref(wt_p))
    if rc != 0:
        return None
    k = out_nnz.value
    try:
        rowptr = np.ctypeslib.as_array(rp_p, shape=(num_rows + 1,)).copy()
        colidx = np.ctypeslib.as_array(ci_p, shape=(max(k, 1),))[:k].copy()
        wout = None
        if wt is not None and wt_p:
            wout = np.ctypeslib.as_array(wt_p, shape=(max(k, 1),))[:k] \
                .copy()
    finally:
        lib.gt_free(rp_p)
        lib.gt_free(ci_p)
        if wt_p:
            lib.gt_free(wt_p)
    return rowptr, colidx, wout
