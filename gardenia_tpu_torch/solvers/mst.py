"""MST — Boruvka minimum spanning tree or forest; torch counterpart of
gardenia_tpu/solvers/mst.py (reference src/mst/main.cu, LonestarGPU).

A round: (1) each component's minimum outgoing edge weight, a scatter-min
keyed by the component of the edge's source; (2) among the edges that
match it, the least canonical undirected edge id (the same id for (u, v)
and (v, u): the tie-break that makes the minima a total order, which
the reference's verify_min_elem plays); (3) one concrete edge slot per
component; (4) those edges are chosen and both endpoints' components
hooked to the smaller root, then pointer jumping.  The rounds repeat
until no component changes; a round reads once, plus once per jumping
level.  An edge chosen from both sides counts once in the weight.

The minima are taken per vertex first, by segment mins over the CSR rows
(a vertex's edges share its component), then per component by a
scatter-min of the vertices that hold a candidate: a scatter-min over
every edge would pile a large component's millions of edges onto one
address (1.28 s of a 1.70 s solve at R-MAT-20 on an H100; PERF.md).

Weights are cast f32 -> int32 (truncation) for the comparisons, as the
JAX solver does; the total weight sums the graph's own weights.  The JAX
solver's edge chunks (MST_EDGE_CHUNK) bounded a TPU row table's memory
and are not ported: a round is one pass over all edges.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import views
from gardenia_tpu_torch.ops.pointer_jump import pointer_jump

INT_MAX = int(np.iinfo(np.int32).max)


@dataclasses.dataclass
class MSTResult:
    # sum of the chosen edges' weights, in f64: the JAX solver rounds it
    # to f32, which is not exact above 2^24 (R-MAT-20's tree weighs more)
    total_weight: float
    edge_mask: torch.Tensor   # bool[nnz]: chosen edge slots (CSR order)
    comp: torch.Tensor        # i32[m]: final components (forest roots)


def _edges(g, dev):
    """(src, dst) i64[nnz] and (w, cid) f64[nnz] on dev: the CSR edges,
    their weights truncated to integers and their canonical undirected
    ids, integers exact in f64, the type of the segment mins below (host
    set-up, cached per graph)."""
    def up():
        m = g.m
        src = np.repeat(np.arange(m, dtype=np.int64), np.diff(g.rowptr))
        dst = np.asarray(g.colidx, np.int64)
        w = (np.ones(g.nnz, np.float32) if g.weights is None
             else np.asarray(g.weights, np.float32))
        # 1-D int64 keys: np.unique over stacked pairs is a slow
        # void-view sort at tens of millions of edges
        key = np.minimum(src, dst) * m + np.maximum(src, dst)
        _, cid = np.unique(key, return_inverse=True)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in (src, dst, w.astype(np.int32).astype(np.float64),
                               cid.astype(np.float64)))
    return g._dev(("torch", "mst_edges", str(dev)), up)


def mst_solver(g, *, device="cuda") -> MSTResult:
    """g: a symmetrized graph (the reference loads with symmetrize=1,
    main.cu:171); unweighted graphs get unit weights (a spanning
    forest)."""
    dev = resolve_device(device)
    m, nnz = g.m, g.nnz
    rowptr = views.csr(g, dev)[0]
    src, dst, w, cid = _edges(g, dev)
    eid = torch.arange(nnz, dtype=torch.float64, device=dev)
    vid = torch.arange(m, dtype=torch.int64, device=dev)
    comp = torch.arange(m, dtype=torch.int32, device=dev)
    chosen = torch.zeros(nnz, dtype=torch.bool, device=dev)
    inf = float("inf")

    def per_vertex(vals, sel):
        """f64[m]: per vertex the least of vals over its selected
        out-edges (inf where none): a vertex's edges are contiguous in
        CSR order, so a segment min, no atomics."""
        return torch.segment_reduce(torch.where(sel, vals, inf), "min",
                                    offsets=rowptr, initial=inf)

    def least(vals, sel, comp_v):
        """f64[m]: per component the least of vals over its selected
        edges (inf where none).  A vertex with a candidate scatter-mins it
        into its component's slot; the others write inf into their own
        slot, which changes nothing and keeps the atomics of a large
        component's edges off one address."""
        v = per_vertex(vals, sel)
        out = torch.full((m,), inf, dtype=torch.float64, device=dev)
        return out.scatter_reduce_(0, torch.where(v < inf, comp_v, vid), v,
                                   "amin")

    while True:
        comp_v = comp.long()
        cs, cd = comp_v[src], comp_v[dst]
        cross = cs != cd
        minw = least(w, cross, comp_v)
        hit = cross & (w == minw[cs])
        mincid = least(cid, hit, comp_v)
        hit &= cid == mincid[cs]
        mine = least(eid, hit, comp_v)
        sel = hit & (eid == mine[cs])
        chosen |= sel
        # one chosen edge a component at most: the vertex that holds it
        # hooks its root and the other end's root to the smaller
        other = per_vertex(cd.double(), sel)
        has = other < inf
        other = torch.where(has, other, 0.0).long()
        hooked = comp.clone()
        hooked.scatter_reduce_(0, torch.where(has, comp_v, vid),
                               torch.where(has, other.int(), INT_MAX),
                               "amin")
        hooked.scatter_reduce_(0, torch.where(has, other, vid),
                               torch.where(has, comp, INT_MAX), "amin")
        comp2 = pointer_jump(hooked)
        if not bool((comp2 != comp).any()):
            break
        comp = comp2
    # an edge chosen from both of its sides counts once: the first slot of
    # each canonical id, as the JAX solver's np.unique(return_index=True)
    idx = torch.nonzero(chosen).squeeze(1)
    ids, order = torch.sort(cid[idx], stable=True)
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    edges = idx[order[first]].cpu().numpy()
    weights = np.ones(nnz) if g.weights is None else np.asarray(g.weights)
    return MSTResult(float(weights[edges].sum()), chosen, comp2)
