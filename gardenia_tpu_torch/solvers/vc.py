"""VC — vertex colouring, Gebremedhin-Manne speculative first-fit; torch
counterpart of gardenia_tpu/solvers/vc.py (reference src/vc/{vc.h,
omp_base.cc}).

Rounds of speculative first-fit (every active vertex takes the smallest
colour no neighbour holds) and conflict resolution (of an edge whose ends
share a colour, the lower id re-enters).  The forbidden colours are a
(m, C) table, first-fit is an argmin over its colour axis (the first
minimum, as jnp.argmin), and the host picks each round's tier from one
read of (active count, their degree sum, the last round's saturation):

  core   — at most K = min(VC_CORE_CAP, next_pow2(m)) vertices active:
           one exact sequential first-fit over them, largest degree
           first (kernel V1, ops/vc_core), and no further conflict;
  sparse — the first (ids, edges) capacity of VC_SPARSE_CAPS that holds
           the active vertices and their edges: their edges expanded
           (ops/frontier), a forbidden table of their rows, first-fit,
           the lower end of each new conflict reactivated;
  dense  — otherwise: one scatter-min of neighbour ids into an (m, C)
           table gives both the conflicts (`active` here means "refit
           last round, test me") and the refit's forbidden set.

The JAX solver runs sparse rounds in device segments and lets a round
whose frontier outgrew its tier do nothing; choosing the tier every round
on the host gives the same colours and the same `iterations`, since a
sparse round's result does not depend on the tier that holds it.  Its
segments (utils/segment, `rounds_per_segment`) only kept a TPU program
under a worker's time limit and are not ported, nor its edge chunks
(VC_EDGE_CHUNK, a 16 GB HBM guard) or its GDN_VC_TIME trace: the result
counts the rounds of each tier instead.

Palette escalation: a vertex whose neighbours use all C colours keeps its
state and stays active; the host doubles C and resumes (up to 2^14).  The
palette that worked is remembered on the graph for the default
`max_color`, so that repeat solves skip the saturated attempts.
"""

from __future__ import annotations

import dataclasses

import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.core import views
from gardenia_tpu_torch.ops import vc_core
from gardenia_tpu_torch.utils.profiler import spanned

# the JAX solver's constants, under its names (tests set them in both)
VC_SPARSE_CAPS = (1 << 17, 1 << 21)
VC_CORE_CAP = 65536
PALETTE_CAP = 1 << 14


@dataclasses.dataclass
class VCResult:
    colors: torch.Tensor   # i32[m]
    num_colors: int
    iterations: int
    rounds: dict           # rounds by tier: dense, sparse, core
    palette: int           # the palette C the solve ended with
    core_size: int         # vertices of the first core pass (0: none)


def _first_fit(forb: torch.Tensor):
    """(fit i32[m], saturated bool[m]) of a 0/1 uint8 or int8 table: the
    first free colour of each row, and whether the row has none."""
    return forb.argmin(1).int(), forb.amin(1) == 1


def dense_round(src, dst, colors, active, C: int):
    """(colors, active, stuck): one merged round over every edge."""
    m = colors.shape[0]
    tab = torch.full((m * C,), m, dtype=torch.int32, device=colors.device)
    tab.scatter_reduce_(0, src.long() * C + colors[dst.long()], dst, "amin")
    tab = tab.view(m, C)
    own = tab.gather(1, colors.long()[:, None])[:, 0]
    vid = torch.arange(m, dtype=torch.int32, device=colors.device)
    conflicted = active & (own < vid)
    fit, satrow = _first_fit((tab < m).view(torch.uint8))
    colors = torch.where(conflicted & ~satrow, fit, colors)
    return colors, conflicted, (conflicted & satrow).any()


def sparse_round(rowptr, colidx, colors, active, C: int, cap_ids: int,
                 cap_edges: int):
    """(colors, active, stuck): first-fit of the active vertices over
    their expanded edges; the lower end of each new conflict re-enters.
    The active vertices and their edges must fit the capacities."""
    from gardenia_tpu_torch.ops.frontier import (compact_mask,
                                                 expand_frontier_edges)
    m = colors.shape[0]
    ids = compact_mask(active, cap_ids, m)
    s, d, valid, _ = expand_frontier_edges(rowptr, colidx, ids, cap_edges)
    s = torch.where(valid, s, 0).long()       # pad slots may hold id m
    d = d.long()
    forb = torch.zeros(m * C + 1, dtype=torch.int8, device=colors.device)
    # only ones are written, so an index assignment is the scatter-max
    forb[torch.where(valid, s * C + colors[d], m * C)] = 1
    fit, sat = _first_fit(forb[:m * C].view(m, C))
    sat &= active
    new = torch.where(active & ~sat, fit, colors)
    ce = valid & (s != d) & (new[s] == new[d])
    conflict = torch.zeros(m + 1, dtype=torch.bool, device=colors.device)
    conflict[torch.where(ce, torch.minimum(s, d), m)] = True
    return new, conflict[:m] | sat, sat.any()


def core_inputs(src, dst, deg, colors, active, C: int):
    """(ids i64[k], forb (k, C) int8, rowptr, col) of the core pass over
    the k active vertices: ids ordered largest degree first (a stable
    sort, ties in id order), their rows forbidden by their non-core
    neighbours' colours, and the lower CSR of the core-core adjacency by
    position in that order (ops/vc_core.core_csr): each position's earlier
    neighbours, whose colours V1 pulls."""
    m = colors.shape[0]
    ids = torch.nonzero(active).squeeze(1)
    k = ids.shape[0]
    ids = ids[torch.argsort(-deg[ids], stable=True)]
    pos = torch.full((m,), k, dtype=torch.int64, device=colors.device)
    pos[ids] = torch.arange(k, device=colors.device)
    ps, pd = pos[src.long()], pos[dst.long()]
    score, dcore = ps < k, pd < k
    forb = torch.zeros(k * C + 1, dtype=torch.int8, device=colors.device)
    # stale colours of core neighbours are not forbidden: V1 recolours them
    forb[torch.where(score & ~dcore, ps * C + colors[dst.long()], k * C)] = 1
    both = score & dcore
    rowptr, col = vc_core.core_csr(ps[both], pd[both], k)
    return ids, forb[:k * C].view(k, C), rowptr, col


def core_pass(src, dst, deg, colors, active, C: int):
    """(colors, active, stuck, k): the exact sequential first-fit of the k
    active vertices; the saturated ones stay active."""
    ids, forb, rowptr, col = core_inputs(src, dst, deg, colors, active, C)
    chosen = vc_core.vc_core_firstfit(forb, rowptr, col)
    got = chosen >= 0
    colors = colors.scatter(0, ids, torch.where(got, chosen, colors[ids]))
    active = torch.zeros_like(active).scatter_(0, ids, ~got)
    return colors, active, (~got).any(), ids.shape[0]


def sparse_tiers(m: int, nnz: int):
    """The distinct (id capacity, edge capacity) tiers of VC_SPARSE_CAPS,
    clamped to the graph as the JAX solver clamps them."""
    tiers = []
    for ec in VC_SPARSE_CAPS:
        ic = min(ec, T.next_pow2(max(m, 2)))
        ec = min(ec, T.next_pow2(max(nnz, 256)))
        if (ic, ec) not in tiers:
            tiers.append((ic, ec))
    return tiers


@spanned("solve.vc")
def vc_solver(g, *, max_color: int = T.MAXCOLOR, device="cuda") -> VCResult:
    """Reference entry int VCSolver(g, colors) (src/vc/vc.h:31) on a
    symmetrized graph (the reference drivers load with symmetrize=1)."""
    dev = resolve_device(device)
    m = g.m
    rowptr, colidx = views.csr(g, dev)
    src, dst = views.coo(g, dev)
    deg = views.degrees(g, dev)
    tiers = sparse_tiers(m, g.nnz)
    # the most vertices a core pass takes: clamped to the graph
    K = min(VC_CORE_CAP, T.next_pow2(max(m, 2)))
    C = max_color
    if max_color == T.MAXCOLOR:
        C = getattr(g, "_vc_palette", max_color)
    colors = torch.zeros(m, dtype=torch.int32, device=dev)
    active = torch.ones(m, dtype=torch.bool, device=dev)
    stuck = torch.zeros((), dtype=torch.bool, device=dev)
    it, core_size = 0, 0
    rounds = {"dense": 0, "sparse": 0, "core": 0}
    while True:
        # one read a round: the frontier, its edges, the last saturation
        cnt, dsum, was_stuck = torch.stack([
            active.sum(), torch.where(active, deg, 0).sum(),
            stuck.long()]).tolist()
        if was_stuck:
            if C >= PALETTE_CAP:
                raise ValueError(
                    f"vertex coloring did not fit {C} colors "
                    "(degeneracy beyond the palette-escalation cap)")
            C *= 2
        if cnt == 0:
            break
        if cnt <= K:
            colors, active, stuck, k = core_pass(src, dst, deg, colors,
                                                 active, C)
            core_size = core_size or k
            rounds["core"] += 1
        else:
            tier = next(((ic, ec) for ic, ec in tiers
                         if cnt <= ic and dsum <= ec), None)
            if tier is not None:
                colors, active, stuck = sparse_round(rowptr, colidx, colors,
                                                     active, C, *tier)
                rounds["sparse"] += 1
            else:
                colors, active, stuck = dense_round(src, dst, colors, active,
                                                    C)
                rounds["dense"] += 1
        it += 1
    if max_color == T.MAXCOLOR:
        g._vc_palette = C
    num_colors = int(colors.max()) + 1 if m else 0
    return VCResult(colors, num_colors, it, rounds, C, core_size)
