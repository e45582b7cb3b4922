"""Per-vertex k-clique counts in each vertex's local bitmap graph (kernel
Q1) — counterpart of the XLA expansion, mask and rotation passes of
gardenia_tpu/mining/kcl.py:175-790, which have no Pallas kernel behind
them.

    ldag = prepare(rowptr, colidx)      # the oriented DAG on the device
    cnt = local_count(ldag, k)          # int64[m]

cnt[u] is the number of k-cliques whose first vertex in DAG order is u.
Q1 (csrc/kcl_local_count.cu) stages N+(u) in shared memory, builds the
local graph A over it (bit j of row i set iff N+(u)[j] is in
N+(N+(u)[i])) and counts k-2 levels of ANDs and popcounts over A: a warp
a vertex for out-degree d <= WARP_DEGREE, a CTA a vertex (shared memory
sized to the class) up to MAX_DEGREE, one launch per non-empty degree
class.  Vertices with d < k - 1 are skipped at set-up.

On CUDA tensors `local_count` launches Q1 or raises (k outside
[MIN_K, MAX_K] or an out-degree above MAX_DEGREE: `route` sends those
to the expansion before any launch).  On CPU tensors, and only there, it
takes `local_count_plain`, the level expansion of mining/kcl.py.
LAUNCHES counts Q1's launches (one a class), never the plain version's.
The limits are constants of the .cu; `kernel_limits()` reads them from
the built library, and every launch checks that they equal the copies
here, which the CPU (no library) needs to choose a route.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MIN_K, MAX_K = 3, 8
WARP_DEGREE = 32          # d <= this: a warp a vertex
MAX_DEGREE = 1024         # d <= this: a CTA a vertex, W <= 32 words a row
# the CTA classes' upper degrees (powers of two): shared memory is sized to
# the class's widest vertex, 4 d + 4 d ceil(d / 32) bytes
CLASSES = (WARP_DEGREE, 64, 128, 256, 512, MAX_DEGREE)

LAUNCHES = 0


class LocalDag(NamedTuple):
    rowptr: torch.Tensor      # int64[m+1]
    colidx: torch.Tensor      # int32[nnz], each row strictly ascending
    order: torch.Tensor       # int32[m]: vertices by ascending out-degree
    degrees: np.ndarray       # int64[m]: their out-degrees, on the host
    max_degree: int


def prepare(rowptr: torch.Tensor, colidx: torch.Tensor) -> LocalDag:
    """The DAG's CSR, checked (int64 rowptr, int32 colidx, contiguous, on
    one device, rows strictly ascending: Q1 searches them) and its
    vertices ordered by out-degree."""
    if rowptr.dtype != torch.int64 or rowptr.dim() != 1:
        raise TypeError(f"rowptr must be a 1-D int64 tensor, got "
                        f"{rowptr.dtype} {tuple(rowptr.shape)}")
    if colidx.dtype != torch.int32 or colidx.dim() != 1:
        raise TypeError(f"colidx must be a 1-D int32 tensor, got "
                        f"{colidx.dtype} {tuple(colidx.shape)}")
    if rowptr.device != colidx.device:
        raise ValueError(f"rowptr on {rowptr.device}, colidx on "
                         f"{colidx.device}")
    if not (rowptr.is_contiguous() and colidx.is_contiguous()):
        raise ValueError("rowptr and colidx must be contiguous")
    m, nnz = rowptr.numel() - 1, colidx.numel()
    deg = rowptr[1:] - rowptr[:-1]
    if m < 0 or int(rowptr[0]) != 0 or int(rowptr[-1]) != nnz or \
            bool((deg < 0).any()):
        raise ValueError("rowptr is not the offsets of colidx's rows")
    if nnz > 1:
        # within a row each id must exceed the one before it
        row_start = torch.zeros(nnz, dtype=torch.bool, device=colidx.device)
        row_start[rowptr[:-1][deg > 0]] = True
        if bool(((colidx[1:] <= colidx[:-1]) & ~row_start[1:]).any()):
            raise ValueError("the DAG's rows are not strictly ascending")
    sdeg, order = torch.sort(deg, stable=True)
    return LocalDag(rowptr, colidx, order.int(), sdeg.cpu().numpy(),
                    int(deg.max()) if m else 0)


def route(max_degree: int, k: int) -> str:
    """"q1" where Q1 takes (k, the widest out-degree), else "expand"."""
    return "q1" if MIN_K <= k <= MAX_K and max_degree <= MAX_DEGREE \
        else "expand"


def kernel_limits() -> dict:
    """Q1's limits as the built library exports them (needs nvcc)."""
    from gardenia_tpu_torch.ops import _build
    so = _build.lib()
    return {"min_k": so.gdn_kcl_min_k(), "max_k": so.gdn_kcl_max_k(),
            "warp_degree": so.gdn_kcl_warp_degree(),
            "max_degree": so.gdn_kcl_max_degree()}


def local_count_plain(ldag: LocalDag, k: int) -> torch.Tensor:
    """int64[m] by the level expansion (mining/kcl.expand_counts)."""
    from gardenia_tpu_torch.mining.kcl import expand_counts
    return expand_counts(ldag.rowptr, ldag.colidx, k)


def class_slices(ldag: LocalDag, k: int):
    """[(first, end, class degree)]: the runs of `order` that Q1 launches
    on, one per non-empty degree class, vertices with d < k - 1 left
    out."""
    begin = int(np.searchsorted(ldag.degrees, k - 1))
    out = []
    for c in CLASSES:
        end = int(np.searchsorted(ldag.degrees, c, side="right"))
        if end > begin:
            out.append((begin, end, c))
        begin = max(begin, end)
    return out


def local_count(ldag: LocalDag, k: int) -> torch.Tensor:
    """int64[m]: the k-cliques whose first vertex in DAG order is u."""
    global LAUNCHES
    dev = ldag.colidx.device
    if dev.type == "cpu":
        return local_count_plain(ldag, k)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if route(ldag.max_degree, k) != "q1":
        raise ValueError(f"Q1 takes {MIN_K} <= k <= {MAX_K} and out-degrees "
                         f"<= {MAX_DEGREE}, got k {k}, out-degree "
                         f"{ldag.max_degree}")
    from gardenia_tpu_torch.ops import _build
    want = {"min_k": MIN_K, "max_k": MAX_K, "warp_degree": WARP_DEGREE,
            "max_degree": MAX_DEGREE}
    if kernel_limits() != want:
        raise RuntimeError(f"csrc/kcl_local_count.cu exports "
                           f"{kernel_limits()}, ops/kcl_count.py has {want}")
    cnt = torch.zeros(ldag.rowptr.numel() - 1, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        for first, end, dmax in class_slices(ldag, k):
            code = _build.lib().gdn_kcl_local_count(
                ldag.rowptr.data_ptr(), ldag.colidx.data_ptr(),
                ldag.order[first:].data_ptr(), end - first, cnt.data_ptr(),
                k, dmax, stream)
            _build.check(code, f"kcl_local_count (k {k}, class d <= {dmax})")
            LAUNCHES += 1
    return cnt
