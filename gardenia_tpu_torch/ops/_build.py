"""Build and load the port's CUDA kernels (csrc/*.cu).

Every source under gardenia_tpu_torch/csrc is compiled by nvcc, at first
use, into one shared library with a plain C interface — one nvcc per
source, all started together, then one link:

  nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
       -Xcompiler -fPIC -c csrc/<name>.cu -o <obj>   (each source)
  nvcc ... -shared -o _build/libgdn_kernels.so <objs>

and loaded with ctypes (pointers as c_void_p, the stream from
torch.cuda.current_stream().cuda_stream).  No PyTorch header is included,
so a build takes seconds.  The library is rebuilt when the hash of the
sources changes.  A missing nvcc or a failed build raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libgdn_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIB = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, $PATH or /usr/local/cuda; raises if absent."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def _nvcc(cmd) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}\n{proc.stderr}")


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into LIB_PATH unless it is current; return it."""
    digest = _digest()
    stamp = LIB_PATH + ".sha256"
    if not force and os.path.exists(LIB_PATH) and os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == digest:
                return LIB_PATH
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    srcs = sources()
    objs = [f"{tmp}.{i}.o" for i in range(len(srcs))]
    try:
        with ThreadPoolExecutor(max(1, len(srcs))) as pool:
            list(pool.map(_nvcc, ([nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
                                  for src, obj in zip(srcs, objs))))
        _nvcc([nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, LIB_PATH)
    with open(tmp, "w") as f:
        f.write(digest)
    os.replace(tmp, stamp)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            so = ctypes.CDLL(build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            so.gdn_dense_panel_matmul.argtypes = [
                vp, ci, vp, vp, vp, ctypes.c_longlong, ci, ci, vp]
            so.gdn_dense_panel_matmul.restype = ci
            ll = ctypes.c_longlong
            # (panel, panel dtype, src, terms, 1 | 3 terms, out, R, W, Sp,
            #  rows a term, stream)
            so.gdn_dense_panel_matmul_tc.argtypes = [
                vp, ci, vp, vp, ci, vp, ll, ci, ci, ll, vp]
            so.gdn_dense_panel_matmul_tc.restype = ci
            # (x, terms, rows, S, Sp, stream)
            so.gdn_split_bf16x3.argtypes = [vp, vp, ll, ci, ci, vp]
            so.gdn_split_bf16x3.restype = ci
            # (panel dtype, terms, registers, local bytes, shared bytes,
            #  stages, CTAs an SM)
            ip = ctypes.POINTER(ci)
            so.gdn_dense_panel_matmul_tc_info.argtypes = [ci, ci] + [ip] * 5
            so.gdn_dense_panel_matmul_tc_info.restype = ci
            # (panel, dtype, src, x2d, out, R, W, sentinel, stream)
            so.gdn_dense_panel_minselect.argtypes = [
                vp, ci, vp, vp, vp, ll, ci, ci, vp]
            so.gdn_dense_panel_minselect.restype = ci
            # (rows, first index, second index, out, n, W|wpad, stream)
            for name in ("gdn_tc_rot_count", "gdn_tc_merge_count",
                         "gdn_tc_bitmap_count"):
                fn = getattr(so, name)
                fn.argtypes = [vp, vp, vp, vp, ll, ci, vp]
                fn.restype = ci
            for name in ("gdn_tc_rot_block", "gdn_tc_merge_block",
                         "gdn_tc_bitmap_block", "gdn_tc_bitmap_tile_words"):
                fn = getattr(so, name)
                fn.argtypes = []
                fn.restype = ci
            # (forb, rowptr, col, chosen, counter, K, C, stream)
            so.gdn_vc_core_firstfit.argtypes = [vp] * 5 + [ci, ci, vp]
            so.gdn_vc_core_firstfit.restype = ci
            # (rowptr, colidx, verts, nverts, cnt, k, dmax, stream)
            so.gdn_kcl_local_count.argtypes = [vp, vp, vp, ll, vp, ci, ci, vp]
            so.gdn_kcl_local_count.restype = ci
            for name in ("gdn_kcl_min_k", "gdn_kcl_max_k",
                         "gdn_kcl_warp_degree", "gdn_kcl_max_degree"):
                fn = getattr(so, name)
                fn.argtypes = []
                fn.restype = ci
            so.gdn_error_string.argtypes = [ci]
            so.gdn_error_string.restype = ctypes.c_char_p
            _LIB = so
        return _LIB


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if code != 0:
        msg = lib().gdn_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
