"""The host Graph container — the port's copy of gardenia_tpu/core/graph.py
(reference include/csr_graph.h).

Host side only: clean CSR in NumPy (rowptr int64, colidx int32, optional
float weights, optional reverse CSR, optional uint8 vertex labels) and a
per-graph cache (`_dev`) of derived views.  The reference's device
methods (`device_csr/coo/weights/degrees`, `ell`, `hybrid`) upload to JAX
and are not copied: gardenia_tpu_torch/core/views.py builds the torch
views instead, in the same cache.

Construction mirrors the reference Graph ctor
(include/csr_graph.h:211-250): Graph(prefix, filetype, symmetrize,
need_reverse), loading .mtx/.gr/.graph/.el text or pre-converted .bin CSR.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from gardenia_tpu_torch.core import build, io
from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.utils.profiler import count, span, spanned


class Graph:
    def __init__(self,
                 rowptr: np.ndarray,
                 colidx: np.ndarray,
                 weights: Optional[np.ndarray] = None,
                 *,
                 num_cols: Optional[int] = None,
                 symmetric: bool = False,
                 need_reverse: bool = False,
                 vlabels: Optional[np.ndarray] = None,
                 elabels: Optional[np.ndarray] = None):
        self.rowptr = np.asarray(rowptr, dtype=T.EID_DTYPE)
        self.colidx = np.asarray(colidx, dtype=T.VID_DTYPE)
        self.weights = None if weights is None else np.asarray(weights)
        self.m = len(self.rowptr) - 1
        self.n = self.m if num_cols is None else int(num_cols)
        self.symmetric = bool(symmetric)
        self.vlabels = vlabels
        self.elabels = elabels
        self._in: Optional[Tuple[np.ndarray, np.ndarray,
                                 Optional[np.ndarray]]] = None
        self._device_cache: Dict = {}
        if need_reverse and not symmetric:
            self._build_reverse()

    # --- basic accessors (reference csr_graph.h:290-306) -------------------
    @property
    def nnz(self) -> int:
        return len(self.colidx)

    def num_vertices(self) -> int:
        return self.m

    def num_edges(self) -> int:
        return self.nnz

    @property
    def degrees(self) -> np.ndarray:
        return build.degrees_from_rowptr(self.rowptr)

    @property
    def max_degree(self) -> int:
        return int(self.degrees.max()) if self.m else 0

    def out_neigh(self, v: int) -> np.ndarray:
        return self.colidx[self.rowptr[v]:self.rowptr[v + 1]]

    def _build_reverse(self):
        self._in = build.transpose_csr(self.n, self.rowptr, self.colidx,
                                       self.weights)

    @property
    def in_rowptr(self) -> np.ndarray:
        if self.symmetric:
            return self.rowptr
        if self._in is None:
            self._build_reverse()
        return self._in[0]

    @property
    def in_colidx(self) -> np.ndarray:
        if self.symmetric:
            return self.colidx
        if self._in is None:
            self._build_reverse()
        return self._in[1]

    @property
    def in_weights(self) -> Optional[np.ndarray]:
        if self.symmetric:
            return self.weights
        if self._in is None:
            self._build_reverse()
        return self._in[2]

    @property
    def in_degrees(self) -> np.ndarray:
        return build.degrees_from_rowptr(self.in_rowptr)

    # --- derived graphs ----------------------------------------------------
    def oriented(self) -> "Graph":
        """Degree-order DAG view (reference csr_graph.h:308-350); symmetric
        input assumed (TC/k-clique call this after symmetrizing)."""
        rp, ci = build.orient_dag(self.rowptr, self.colidx)
        return Graph(rp, ci, num_cols=self.n, vlabels=self.vlabels)

    # --- derived views (cached) -------------------------------------------
    def _dev(self, key, fn, retain=None):
        """Cached build of a derived view.

        retain: object(s) whose id() participates in `key` (e.g. a caller
        -supplied weights array).  The cache holds a strong reference so
        the id can never be recycled by a different object while the
        entry is alive.  While the recorder (utils/profiler) is on, a build
        is a span layout.<kind> (the key's ("torch", kind, ...), else its
        first element) and a count of layout_builds, a hit a count of
        layout_hits."""
        if key in self._device_cache:
            count("layout_hits")
        else:
            kind = key[1] if key[0] == "torch" else key[0]
            with span(f"layout.{kind}"):
                self._device_cache[key] = (fn(), retain)
            count("layout_builds")
        return self._device_cache[key][0]

    def __getstate__(self):
        """A Graph is pickled (to hand it to another process, such as a
        rank of parallel/) with its arrays only: the cache of derived
        views may hold device tensors, and is rebuilt where it is used."""
        state = dict(self.__dict__)
        state["_device_cache"] = {}
        return state

    def __repr__(self):
        return (f"Graph(|V|={self.m}, |E|={self.nnz}, "
                f"symmetric={self.symmetric}, weighted="
                f"{self.weights is not None})")


def from_csr_of(g) -> Graph:
    """A port Graph over the numpy CSR of another host Graph (such as the
    JAX package's), sharing its arrays; the caches stay separate."""
    return Graph(g.rowptr, g.colidx, g.weights, num_cols=g.n,
                 symmetric=g.symmetric, vlabels=g.vlabels, elabels=g.elabels)


@spanned("graph.from_edges")
def from_edges(edges: io.EdgeListData, *, symmetrize: bool = False,
               need_reverse: bool = False, remove_self_loops: bool = True,
               dedup: bool = True, keep_weights: bool = True) -> Graph:
    """Clean a parsed edge list into a Graph (reference fill_data path).

    Uses the native C++ builder (native/csr_build.cpp: radix sort +
    dedup + prefix sum) when available, with the NumPy path as the
    always-correct fallback (parity-tested)."""
    from gardenia_tpu_torch import native

    wt = edges.wt if keep_weights else None
    rp = None
    span = max(edges.num_rows, edges.num_cols)
    use_native = native.builder_available() and not (
        symmetrize and edges.num_cols != edges.num_rows)
    nat = native.build_csr(span, edges.src, edges.dst, wt,
                           remove_self_loops=remove_self_loops,
                           dedup=dedup, symmetrize=symmetrize) \
        if use_native else None
    if nat is not None:
        rp, ci, w = nat
        rp = rp[:edges.num_rows + 1]      # bipartite: rows only
    if rp is None:
        src, dst, wt = build.clean_edges(
            edges.src, edges.dst, wt, num_rows=edges.num_rows,
            remove_self_loops=remove_self_loops, dedup=dedup,
            symmetrize=symmetrize)
        rp, ci, w = build.coo_to_csr(edges.num_rows, src, dst, wt,
                                     sorted_by_src=True)
    # Match reference semantics: only an explicit symmetrize flag makes the
    # graph undirected (the MatrixMarket 'symmetric' banner is recorded on
    # EdgeListData but not auto-expanded; csr_graph.h:104-117).
    return Graph(rp, ci, w, num_cols=edges.num_cols, symmetric=symmetrize,
                 need_reverse=need_reverse, vlabels=edges.vlabels)


def load_graph(prefix: str, filetype: str = "auto", symmetrize: bool = False,
               need_reverse: bool = False, **kw) -> Graph:
    """Load a graph the way the reference Graph ctor does
    (include/csr_graph.h:211-250).

    prefix: path with or without extension. filetype: 'mtx' | 'gr' |
    'graph' | 'el' | 'bin' | 'auto'.
    """
    if filetype == "auto":
        if os.path.exists(prefix + ".meta.txt"):
            filetype = "bin"
        else:
            ext = os.path.splitext(prefix)[1].lstrip(".")
            filetype = ext if ext in ("mtx", "gr", "graph", "el") else "mtx"
    if filetype == "bin":
        rowptr, colidx, vlabels = io.read_bin_csr(prefix)
        if symmetrize:
            src, dst = build.csr_to_coo(rowptr, colidx)
            src, dst, _ = build.clean_edges(src, dst, num_rows=len(rowptr) - 1,
                                            symmetrize=True)
            rowptr, colidx, _ = build.coo_to_csr(len(rowptr) - 1, src, dst,
                                                 sorted_by_src=True)
        return Graph(rowptr, colidx, symmetric=symmetrize,
                     need_reverse=need_reverse, vlabels=vlabels)
    path = prefix if os.path.splitext(prefix)[1] else f"{prefix}.{filetype}"
    edges = io.parse_text(path, filetype)
    return from_edges(edges, symmetrize=symmetrize,
                      need_reverse=need_reverse, **kw)
