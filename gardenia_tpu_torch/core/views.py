"""Torch device views of the host Graph (core/graph.py).

They take the place of the reference Graph's `device_*`, `ell` and
`hybrid` methods: built from the Graph's numpy CSR and cached in its
per-graph cache (`Graph._dev`) under keys ("torch", kind, device, ...).
A symmetric graph's forward and reverse views are one CSR, so they share
one cache entry, as the reference's `hybrid` does (graph.py:185-186).
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu_torch.core import types as T


def _key(kind: str, device, *rest):
    return ("torch", kind, str(torch.device(device)), *rest)


def _dir(g, reverse: bool) -> str:
    return "reverse" if reverse or g.symmetric else "forward"


def _csr_arrays(g, reverse: bool):
    return (g.in_rowptr, g.in_colidx) if reverse else (g.rowptr, g.colidx)


def degrees(g, device, reverse: bool = False) -> torch.Tensor:
    """i32[m] out-degrees (in-degrees when reverse)."""
    def mk():
        deg = g.in_degrees if reverse else g.degrees
        return torch.from_numpy(np.asarray(deg, T.VID_DTYPE)).to(device)
    return g._dev(_key("deg", device, _dir(g, reverse)), mk)


def csr(g, device, reverse: bool = False):
    """(rowptr i64[m+1], colidx i32[nnz]) of g (of its transpose when
    reverse)."""
    def mk():
        rp, ci = _csr_arrays(g, reverse)
        return (torch.from_numpy(np.asarray(rp, np.int64)).to(device),
                torch.from_numpy(np.asarray(ci, T.VID_DTYPE)).to(device))
    return g._dev(_key("csr", device, _dir(g, reverse)), mk)


def coo(g, device):
    """(src i32[nnz], dst i32[nnz]) of g's edges, src-sorted."""
    def mk():
        from gardenia_tpu_torch.core import build
        s, d = build.csr_to_coo(g.rowptr, g.colidx)
        return (torch.from_numpy(np.asarray(s, T.VID_DTYPE)).to(device),
                torch.from_numpy(np.asarray(d, T.VID_DTYPE)).to(device))
    return g._dev(_key("coo", device), mk)


def coo_sorted(g, device, reverse: bool = False):
    """(rows i32[nnz], non-decreasing; cols i32[nnz]) of g's CSR (of its
    transpose when reverse): the edge list that ops/spmv.spmv_batched
    sums by row."""
    def mk():
        rp, ci = _csr_arrays(g, reverse)
        rows = np.repeat(np.arange(g.m, dtype=T.VID_DTYPE), np.diff(rp))
        return (torch.from_numpy(rows).to(device),
                torch.from_numpy(np.asarray(ci, T.VID_DTYPE)).to(device))
    return g._dev(_key("coo_sorted", device, _dir(g, reverse)), mk)


def edge_weights(g, device, dtype=torch.float32) -> torch.Tensor:
    """g's edge weights in CSR order as f32, then as `dtype` (an integer
    dtype truncates, as numpy's astype does); all ones when g is
    unweighted."""
    def mk():
        w = (np.ones(g.nnz, np.float32) if g.weights is None
             else np.asarray(g.weights, np.float32))
        return torch.from_numpy(w).to(device=device, dtype=dtype)
    return g._dev(_key("weights", device, str(dtype)), mk)


def ell(g, device, reverse: bool = False, weighted: bool = False):
    """ELL slab matrix of g (of its transpose when reverse); with
    `weighted`, its values are g's weights (ones when g has none), as the
    reference's Graph.ell(weighted=True) builds it (graph.py:161-176)."""
    def mk():
        from gardenia_tpu_torch.ops.ell import build_ell
        rp, ci = _csr_arrays(g, reverse)
        w = None
        if weighted:
            w = g.in_weights if reverse else g.weights
            w = (np.ones(len(ci), np.float32) if w is None
                 else np.asarray(w, np.float32))
        return build_ell(rp, ci, w, num_cols=g.n).to(device)
    # the unweighted views keep the key they have always had
    options = ("weighted",) if weighted else ()
    return g._dev(_key("ell", device, _dir(g, reverse), *options), mk)


def hybrid(g, device, reverse: bool = False):
    """Unweighted hybrid block-sparse matrix (threshold 16) of g (of its
    transpose when reverse).  Build block locality first with
    core/relabel.py on scatter-labelled graphs."""
    def mk():
        from gardenia_tpu_torch.ops.bsr import build_hybrid
        rp, ci = _csr_arrays(g, reverse)
        return build_hybrid(rp, ci, None, num_cols=g.n).to(device)
    return g._dev(_key("hybrid", device, _dir(g, reverse)), mk)


def relabel_maps(g, device):
    """(relabelled graph, new_of_old i64[m], old_of_new i64[m]) of the
    degree relabelling (core/relabel.py), the maps on `device`."""
    from gardenia_tpu_torch.core.relabel import relabeled
    rel = relabeled(g)

    def up():
        return (torch.from_numpy(np.asarray(rel.new_of_old, np.int64))
                .to(device),
                torch.from_numpy(np.asarray(rel.old_of_new, np.int64))
                .to(device))
    new_of_old, old_of_new = g._dev(_key("relabel_maps", device), up)
    return rel.graph, new_of_old, old_of_new


def relabeled_hybrid(g, device, reverse: bool = True):
    """(relabelled graph, its hybrid matrix, new_of_old tensor) — the
    degree-relabelled layout that the pull sweeps run on: the reverse
    (in-edge) matrix by default, the forward one for BC's backward pass
    and the SpMV bench."""
    g2, new_of_old, _ = relabel_maps(g, device)
    return g2, hybrid(g2, device, reverse=reverse), new_of_old
