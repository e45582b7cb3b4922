"""Vectorized (NumPy) graph construction: COO -> clean CSR.

Re-expresses the reference's adjacency-list builders
(include/csr_graph.h:122-196 fill_data, include/graph_io.h:25-143) as
O(E log E) vectorized sorts instead of per-vertex std::vector loops:
  * neighbor-list sort      -> single lexsort over (src, dst)
  * self-loop removal       -> boolean mask
  * redundant-edge removal  -> adjacent-duplicate mask after sort
  * symmetrize              -> concat of (src,dst) and (dst,src)
  * reverse (transpose)     -> CSR build with roles swapped
  * DAG orientation         -> degree-order edge filter
                               (csr_graph.h:308-350 orientation())
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gardenia_tpu_torch.core import types as T


def clean_edges(src, dst, wt=None, *, num_rows: int,
                remove_self_loops: bool = True,
                dedup: bool = True,
                symmetrize: bool = False):
    """Sort/clean a COO edge list. Returns (src, dst, wt) sorted by (src, dst).

    Matches reference fill_data semantics (csr_graph.h:122-156): sort each
    neighbor list, drop self loops, drop duplicate (src,dst) pairs keeping
    the first. symmetrize adds the reversed copy of every non-self-loop edge
    BEFORE dedup (csr_graph.h:104-117).
    """
    src = np.asarray(src, dtype=T.VID_DTYPE)
    dst = np.asarray(dst, dtype=T.VID_DTYPE)
    if remove_self_loops:
        keep = src != dst
        if not keep.all():
            src, dst = src[keep], dst[keep]
            if wt is not None:
                wt = wt[keep]
    if symmetrize:
        if remove_self_loops:
            rs, rd = dst, src
            rw = wt
        else:
            nonloop = src != dst
            rs, rd = dst[nonloop], src[nonloop]
            rw = wt[nonloop] if wt is not None else None
        src = np.concatenate([src, rs])
        dst = np.concatenate([dst, rd])
        if wt is not None:
            wt = np.concatenate([wt, rw])
    order = np.lexsort((dst, src))
    src, dst = src[order], dst[order]
    if wt is not None:
        wt = wt[order]
    if dedup and len(src):
        uniq = np.empty(len(src), dtype=bool)
        uniq[0] = True
        np.logical_or(src[1:] != src[:-1], dst[1:] != dst[:-1], out=uniq[1:])
        if not uniq.all():
            if wt is not None and symmetrize:
                # Combine duplicate weights with min so the symmetrized
                # weight matrix is symmetric even when the input has
                # parallel edges with differing weights (the reference
                # keeps an arbitrary copy — std::sort is unstable,
                # csr_graph.h:131-143 — and then aliases the reverse
                # graph, so it silently relies on symmetric weights).
                gid = np.cumsum(uniq) - 1
                wmin = np.full(gid[-1] + 1, np.inf)
                np.minimum.at(wmin, gid, wt)
                wt = wmin
                src, dst = src[uniq], dst[uniq]
            else:
                src, dst = src[uniq], dst[uniq]
                if wt is not None:
                    wt = wt[uniq]
    return src, dst, wt


def coo_to_csr(num_rows: int, src, dst, wt=None, *, sorted_by_src: bool = False
               ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """COO -> CSR (rowptr int64[m+1], colidx int32[nnz], weights or None)."""
    if not sorted_by_src:
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        if wt is not None:
            wt = wt[order]
    counts = np.bincount(src, minlength=num_rows)
    rowptr = np.zeros(num_rows + 1, dtype=T.EID_DTYPE)
    np.cumsum(counts, out=rowptr[1:])
    return rowptr, np.ascontiguousarray(dst, dtype=T.VID_DTYPE), wt


def csr_to_coo(rowptr: np.ndarray, colidx: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """CSR -> (src, dst) with src = repeat(row id, degree)."""
    deg = np.diff(rowptr)
    src = np.repeat(np.arange(len(deg), dtype=T.VID_DTYPE), deg)
    return src, colidx


def transpose_csr(num_cols: int, rowptr: np.ndarray, colidx: np.ndarray,
                  wt: Optional[np.ndarray] = None):
    """Build the reverse (in-edge) CSR — reference build_reverse_graph
    (csr_graph.h:170-196). Neighbor lists of the result are sorted."""
    src, dst = csr_to_coo(rowptr, colidx)
    return coo_to_csr(num_cols, dst, src, wt)


def orient_dag(rowptr: np.ndarray, colidx: np.ndarray):
    """Degree-order DAG orientation: keep edge (u,v) iff deg(v) > deg(u) or
    (deg(v) == deg(u) and v > u) — reference csr_graph.h:308-350."""
    deg = np.diff(rowptr).astype(T.VID_DTYPE)
    src, dst = csr_to_coo(rowptr, colidx)
    ds, dd = deg[src], deg[dst]
    keep = (dd > ds) | ((dd == ds) & (dst > src))
    return coo_to_csr(len(deg), src[keep], dst[keep], sorted_by_src=True)[:2]


def degrees_from_rowptr(rowptr: np.ndarray) -> np.ndarray:
    return np.diff(rowptr).astype(T.VID_DTYPE)
