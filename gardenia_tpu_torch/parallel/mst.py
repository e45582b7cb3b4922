"""Multi-device Boruvka MST: contiguous edge ranges sharded, the component
table replicated, the per-round minimum tables merged by MIN all-reduces
— the torch counterpart of gardenia_tpu/parallel/mst.py.

Reference: src/mst/main.cu:12-129 (LonestarGPU Boruvka).  Each rank owns
the out-edges of a contiguous (edge-balanced) row range.  A round builds
the three per-component minimum tables of the single-device solver —
least weight, then among those edges the least canonical undirected edge
id, then the least edge slot — each by a local scatter-min and a MIN
all-reduce, in that order, which together take the lexicographic argmin;
every table is int32 as the JAX package keeps them, so ties break as
there.  The chosen edges then hook both ends' roots on every rank's
replicated table, merged by one more MIN all-reduce, and pointer jumping
runs on the replicated table: 4 all-reduces a round.
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.ops.pointer_jump import pointer_jump
from gardenia_tpu_torch.parallel.partition import shard_bounds
from gardenia_tpu_torch.solvers.mst import MSTResult

INT_MAX = int(np.iinfo(np.int32).max)


def _edge_range(g, n: int, balance: str):
    """(edge cuts i64[n+1], padded edges a rank): the contiguous edge
    ranges of the row ranges."""
    cuts = np.asarray(g.rowptr, np.int64)[shard_bounds(g.rowptr, n, balance)]
    emax = T.round_up(max(int(np.diff(cuts).max()), T.LANES), T.LANES)
    return cuts, emax


def _scatter_min(size: int, idx, vals, fill: int) -> torch.Tensor:
    """i32[size]: fill, scatter-min'd with vals at idx; an idx of size is
    dropped."""
    out = torch.full((size + 1,), fill, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce_(0, idx, vals, "amin")[:size]


def mst_solver_dist(g, *, mesh, balance: str = "edges") -> MSTResult:
    """Distributed Boruvka on symmetric weighted g on every rank of mesh:
    the MSTResult of the single-device solver (the total weight counts
    an edge chosen from both sides once; f64 sum of g's own weights)."""
    dev, n = mesh.device, mesh.size
    m, nnz = g.m, g.nnz
    cuts, emax = _edge_range(g, n, balance)
    e0, e1 = int(cuts[mesh.rank]), int(cuts[mesh.rank + 1])
    src_h = np.repeat(np.arange(m, dtype=np.int64), np.diff(g.rowptr))
    dst_h = np.asarray(g.colidx, np.int64)
    w_h = np.ones(nnz, np.float32) if g.weights is None else \
        np.asarray(g.weights, np.float32)
    # canonical undirected edge ids: (u, v) and (v, u) share one
    key = np.minimum(src_h, dst_h) * m + np.maximum(src_h, dst_h)
    _, cid_h = np.unique(key, return_inverse=True)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a[e0:e1])).to(dev)
    src, dst = up(src_h), up(dst_h)
    wi = up(w_h.astype(np.int32))              # truncated, as the JAX does
    cid = up(cid_h.astype(np.int32))
    eid = torch.arange(e0, e1, dtype=torch.int32, device=dev)
    comp = torch.arange(m, dtype=torch.int32, device=dev)
    chosen = torch.zeros(e1 - e0, dtype=torch.bool, device=dev)
    while True:
        cs, cd = comp[src].long(), comp[dst].long()
        cross = cs != cd
        cs_c = cs.clamp(max=m - 1)
        # 1) the least weight a component, 2) among its edges of that
        # weight the least canonical id, 3) the least edge slot
        minw = mesh.all_reduce(_scatter_min(
            m, torch.where(cross, cs, m), torch.where(cross, wi, INT_MAX),
            INT_MAX), "min")
        hit1 = cross & (wi == minw[cs_c])
        mincid = mesh.all_reduce(_scatter_min(
            m, torch.where(hit1, cs, m), torch.where(hit1, cid, INT_MAX),
            INT_MAX), "min")
        hit = hit1 & (cid == mincid[cs_c])
        mine = mesh.all_reduce(_scatter_min(
            m, torch.where(hit, cs, m), torch.where(hit, eid, nnz), nnz),
            "min")
        sel = hit & (eid == mine[cs_c])
        chosen |= sel
        # 4) both ends' roots hooked to the smaller, on the replicated
        # table, merged by MIN (roots no rank chose stay put)
        hooked = torch.cat([comp, comp.new_full((1,), INT_MAX)])
        hooked.scatter_reduce_(0, torch.where(sel, cs, m),
                               torch.where(sel, cd.int(), INT_MAX), "amin")
        hooked.scatter_reduce_(0, torch.where(sel, cd, m),
                               torch.where(sel, cs.int(), INT_MAX), "amin")
        comp2 = pointer_jump(mesh.all_reduce(hooked[:m], "min"))
        if not bool((comp2 != comp).any()):
            break
        comp = comp2
    # the global chosen mask from the ranks' padded edge ranges
    mask = torch.zeros(emax, dtype=torch.int32, device=dev)
    mask[:e1 - e0] = chosen.int()
    gathered = mesh.all_gather(mask).view(n, emax).cpu().numpy()
    chosen_h = np.zeros(nnz, bool)
    for s in range(n):
        chosen_h[cuts[s]:cuts[s + 1]] = gathered[s, :cuts[s + 1] - cuts[s]]
    # an edge chosen from both sides counts once
    _, first = np.unique(cid_h[chosen_h], return_index=True)
    weights = np.ones(nnz) if g.weights is None else np.asarray(g.weights)
    total = float(weights[np.flatnonzero(chosen_h)[first]].sum())
    return MSTResult(total, torch.from_numpy(chosen_h).to(dev), comp2)
