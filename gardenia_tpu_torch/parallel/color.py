"""Multi-device vertex colouring and SCC: edge-sharded rounds — the torch
counterpart of gardenia_tpu/parallel/color.py.

Per-vertex state is small and kept whole on every rank; the EDGE work is
split, and each rank's per-edge scatters merge with all-reduce max, min
or sum, in place of the single-device solvers' atomics:

  VC: edges are OWNER-sharded by their source's range (edge-balanced
      bounds), so each rank's forbidden-colour table covers only its own
      (R, C) rows and its conflict re-queueing is local; colours are
      all-gathered twice a round (before first-fit and before the
      conflict test), and the conflict count is all-reduced.  Vertex ids
      are the padded-global ones of parallel/partition (R rows a rank), so
      the src < dst tie-break is the JAX package's exactly.
  SCC: FB-Trim as solvers/scc.py: the trim's degree counts, the forward
      max-id colouring and the backward closure each scatter over the
      rank's contiguous slice of the edges and all-reduce (sum, max).

The reference's one-hot row select (`rowsel.take`) is plain indexing.
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.parallel.partition import (RowRanges,
                                                   edge_balanced_bounds)
from gardenia_tpu_torch.solvers.scc import SCCResult
from gardenia_tpu_torch.solvers.vc import VCResult


def vc_solver_dist(g, *, mesh, max_color: int = T.MAXCOLOR) -> VCResult:
    """Distributed Gebremedhin-Manne colouring of symmetric g on every
    rank of mesh: speculative first-fit rounds until no edge conflicts;
    the colours of all vertices on every rank."""
    dev, n, s = mesh.device, mesh.size, mesh.rank
    C = max_color
    bounds = edge_balanced_bounds(g.rowptr, n)
    R = T.round_up(max(1, int(np.max(np.diff(bounds)))), 8)
    ranges = RowRanges(bounds, R)
    lo, hi = ranges.shard_range(s)
    # this rank's edges: those whose source it owns, source as a local
    # row, destination as a padded-global id
    e0, e1 = int(g.rowptr[lo]), int(g.rowptr[hi])
    src_l = np.repeat(np.arange(hi - lo, dtype=np.int64),
                      np.diff(g.rowptr[lo:hi + 1]))
    dst_g = ranges.pad_map(g.colidx[e0:e1]).astype(np.int64)
    src_l = torch.from_numpy(src_l).to(dev)
    dst_g = torch.from_numpy(dst_g).to(dev)
    gsrc = src_l + s * R
    real = torch.arange(R, device=dev) < hi - lo
    colors = torch.zeros(R, dtype=torch.int32, device=dev)
    active = real.clone()
    it = 0
    n_conf = int(mesh.all_reduce(real.sum(dtype=torch.int32)))
    while n_conf > 0:
        cd = mesh.all_gather(colors)[dst_g].long()
        a = active[src_l]
        forb = torch.zeros(R * C, dtype=torch.uint8, device=dev)
        forb[(src_l * C + cd)[a]] = 1
        fit = torch.argmin(forb.view(R, C), dim=1).to(torch.int32)
        colors = torch.where(active, fit, colors)
        upd = mesh.all_gather(colors)
        conf = (gsrc < dst_g) & (colors[src_l] == upd[dst_g])
        active = torch.zeros(R, dtype=torch.bool, device=dev)
        active[src_l[conf]] = True
        # the round's one host read: conflicts left on all ranks
        n_conf = int(mesh.all_reduce(active.sum(dtype=torch.int32)))
        it += 1
    ncol = int(mesh.all_reduce(
        torch.where(real, colors, -1).max(), "max")) + 1
    return VCResult(ranges.from_padded(mesh.all_gather(colors)), ncol, it,
                    {"speculative": it}, C, 0)


def scc_solver_dist(g, *, mesh, max_rounds: int = None) -> SCCResult:
    """Distributed FB-Trim SCC of directed g on every rank of mesh: the
    pivot id of each vertex's SCC on every rank."""
    dev, n = mesh.device, mesh.size
    m = g.m
    if max_rounds is None:
        max_rounds = m + 2
    # this rank's contiguous slice of the edges (the JAX package's split:
    # per = nnz / n rounded up to a multiple of 8)
    per = T.round_up(max(1, -(-g.nnz // n)), 8)
    e0 = min(g.nnz, mesh.rank * per)
    e1 = min(g.nnz, e0 + per)
    src_h = np.repeat(np.arange(m, dtype=np.int64), np.diff(g.rowptr))
    src = torch.from_numpy(src_h[e0:e1]).to(dev)
    dst = torch.from_numpy(np.asarray(g.colidx[e0:e1], np.int64)).to(dev)
    vid = torch.arange(m, dtype=torch.int32, device=dev)
    zeros = torch.zeros(m, dtype=torch.int32, device=dev)

    def scatter(idx, vals, how):
        if how == "sum":
            return zeros.index_add(0, idx, vals)
        return zeros.scatter_reduce(0, idx, vals, "amax")

    root = torch.full((m,), -1, dtype=torch.int32, device=dev)
    active = torch.ones(m, dtype=torch.bool, device=dev)
    it = 0
    while bool(active.any()) and it < max_rounds:
        while True:                                  # trim
            ea = (active[src] & active[dst]).to(torch.int32)
            ind = mesh.all_reduce(scatter(dst, ea, "sum"))
            outd = mesh.all_reduce(scatter(src, ea, "sum"))
            trivial = active & ((ind == 0) | (outd == 0))
            root = torch.where(trivial, vid, root)
            active = active & ~trivial
            if not bool(trivial.any()):
                break
        color = torch.where(active, vid, -1)         # forward max-id colour
        changed = bool(active.any())
        while changed:
            ea = active[src] & active[dst]
            x = torch.where(ea, color[src], -1)
            pushed = mesh.all_reduce(scatter(dst, x, "max"), "max")
            new = torch.where(active, torch.maximum(color, pushed), color)
            changed = bool((new != color).any())
            color = new
        reach = active & (color == vid)              # backward closure
        changed = bool(reach.any())
        while changed:
            ea = active[src] & active[dst] & (color[src] == color[dst])
            x = (ea & reach[dst]).to(torch.int32)
            pushed = mesh.all_reduce(scatter(src, x, "max")) > 0
            new = reach | pushed
            changed = bool((new != reach).any())
            reach = new
        in_scc = active & reach
        root = torch.where(in_scc, color, root)
        active = active & ~in_scc
        it += 1
    return SCCResult(root, it)
