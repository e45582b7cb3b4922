"""BFS — direction-optimizing (Beamer) breadth-first search; torch
counterpart of gardenia_tpu/solvers/bfs.py (reference
src/bfs/{bfs.h,omp_beamer.cc,linear_lb.cu,fusion.cu}).  Output contract:
dist[v] = hop depth from the source, MYINFINITY if unreachable
(omp_beamer.cc:166-169).

Variants:
  'pull'     — dense bottom-up every level: the frontier is a mask, a
               level is one count sweep (frontier in-neighbours per row)
               over the unvisited rows.
  'do'       — Beamer direction-optimizing: a compacted top-down step
               (frontier ids -> flattened out-edges, ops/frontier) or the
               dense bottom-up step, by the reference's alpha = 15 / beta
               = 18 heuristic (omp_beamer.cc:111,136-149).
  'do_fused' — the same choice made per level from `scout` (the
               frontier's out-edges) and `work_bu` (the unvisited rows'
               in-edges) over graduated tiers: top-down while the
               frontier is small, a SPARSE bottom-up step (only the
               unvisited rows' in-edges) after the explosion, the dense
               sweep in between.
  bfs_multi_source — S sources at once, state (m, S): a level is one
               batched sweep (ops/bsr.spmv_hybrid_batched, K1 on tensor
               cores, or ops/spmv.spmv_batched on the 'ell' layout).

The JAX solvers fuse their level loop in one lax.while_loop, with a
lax.switch over the tiers in do_fused.  Here every loop runs on the host
and reads back once per level (pull, multi-source: whether a vertex was
discovered; do_fused: that, scout and work_bu, stacked into one read; do:
the next frontier's size and scout).  The tier rule is the JAX package's,
so the same level takes the same branch; the shapes need not be static
here, so a step's capacity is the level's exact edge count, not the
tier's, and 'do' does not snap its capacities to powers of four: its
top-down step after a bottom-up phase takes the frontier's true out-edge
count, where the JAX solver takes the snapped heuristic scout of 1 (256
slots).

Layouts of the count sweep (pull, do_fused, multi-source):
  'hybrid' — the degree-relabelled hybrid layout (ops/bsr.py), dense
             panels through kernel K1; depths map back to original ids.
  'ell'    — ELL slabs over the original ids (multi-source: the
             dst-sorted COO edges).
  'auto'   — hybrid.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.core import views
from gardenia_tpu_torch.ops.frontier import (compact_mask,
                                             expand_frontier_edges,
                                             frontier_degree_sum)
from gardenia_tpu_torch.ops.semiring import I32_PLUS_TIMES
from gardenia_tpu_torch.ops.spmv import spmv_ell
from gardenia_tpu_torch.utils.profiler import host_read, span, spanned

ALPHA = 15   # reference omp_beamer.cc:111
BETA = 18

INF = int(T.MYINFINITY)


@dataclasses.dataclass
class BFSResult:
    dist: torch.Tensor     # i32[m] (multi-source: i32[m, S]); INF = unreached
    iterations: int


def _resolve_layout(layout: str) -> str:
    if layout == "auto":
        return "hybrid"
    if layout not in ("hybrid", "ell"):
        raise ValueError(f"unknown BFS layout {layout!r}")
    return layout


def _count_sweep(g, layout: str, dev):
    """(graph the sweep runs on, fn(mask) -> in-neighbour counts,
    new_of_old or None)."""
    if layout == "hybrid":
        from gardenia_tpu_torch.ops.bsr import spmv_hybrid
        g2, hyb, new_of_old = views.relabeled_hybrid(g, dev)
        return g2, (lambda mask: spmv_hybrid(hyb, mask.float(),
                                             num_rows=g.m)), new_of_old
    in_ell = views.ell(g, dev, reverse=True)
    return g, (lambda mask: spmv_ell(in_ell, mask.to(torch.int32),
                                     semiring=I32_PLUS_TIMES,
                                     num_rows=g.m)), None


def _start(m: int, source, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    dist = torch.full((m,), INF, dtype=torch.int32, device=dev)
    dist[source] = 0
    mask = torch.zeros(m, dtype=torch.bool, device=dev)
    mask[source] = True
    return dist, mask


def bfs_pull(g, source: int, *, layout: str = "auto",
             device="cuda") -> BFSResult:
    layout = _resolve_layout(layout)
    dev = resolve_device(device)
    _, sweep, new_of_old = _count_sweep(g, layout, dev)
    if new_of_old is not None:
        source = host_read(new_of_old[source])
    dist, mask = _start(g.m, source, dev)
    depth = 0
    alive = True
    while alive:
        with span("bfs.level"):
            mask = (sweep(mask) > 0) & (dist == INF)
            dist = torch.where(mask, depth + 1, dist)
            depth += 1
            alive = host_read(mask.any())   # the level's one read
    if new_of_old is not None:
        dist = dist[new_of_old]
    return BFSResult(dist, depth)


# --- direction-optimizing --------------------------------------------------

def _relax(dist: torch.Tensor, tgt: torch.Tensor, depth: int) -> torch.Tensor:
    """dist.at[tgt].min(depth + 1, mode="drop") for targets that are
    unvisited or the pad id m: every write carries the same value."""
    ext = torch.cat([dist, dist.new_empty(1)])
    ext[tgt.long()] = depth + 1
    return ext[:-1]


def _td_level(rowptr, colidx, deg, dist, mask, depth: int, cap: int):
    """Top-down: the frontier's out-edges, flattened, relax their
    unvisited targets.  Degree-0 frontier vertices contribute no edge, so
    `cap` edges bound the id count too."""
    m = dist.shape[0]
    cap = max(cap, 1)
    ids = compact_mask(mask & (deg > 0), min(m, cap), m)
    _, dst, valid, _ = expand_frontier_edges(rowptr, colidx, ids, cap)
    tgt = torch.where(valid & (dist[dst] == INF), dst, m)
    dist = _relax(dist, tgt, depth)
    return dist, dist == depth + 1


def _bu_sparse_level(rowptr_r, colidx_r, deg_in, dist, depth: int, cap: int):
    """Sparse bottom-up: the unvisited rows' in-edges, flattened; a row
    joins the frontier iff an in-neighbour sits at the current depth."""
    m = dist.shape[0]
    cap = max(cap, 1)
    ids = compact_mask((dist == INF) & (deg_in > 0), min(m, cap), m)
    u, w, valid, _ = expand_frontier_edges(rowptr_r, colidx_r, ids, cap)
    tgt = torch.where(valid & (dist[w] == depth), u, m)
    dist = _relax(dist, tgt, depth)
    return dist, dist == depth + 1


def _bu_dense_level(sweep, dist, mask, depth: int):
    newly = (sweep(mask) > 0) & (dist == INF)
    return torch.where(newly, depth + 1, dist), newly


def bfs_do(g, source: int, *, device="cuda") -> BFSResult:
    """Direction-optimizing BFS (host-driven level loop), as the
    reference's omp_beamer.cc: bottom-up (dense, over the in-ELL) while
    the frontier's out-edges exceed the unexplored edges / alpha, top-down
    otherwise."""
    dev = resolve_device(device)
    m = g.m
    rowptr, colidx = views.csr(g, dev)
    deg = views.degrees(g, dev)
    _, sweep, _ = _count_sweep(g, "ell", dev)
    dist, mask = _start(m, source, dev)
    n_frontier = 1
    # scout drives the heuristic (the reference resets it to 1 after a
    # bottom-up phase); out_edges is the frontier's true out-edge count,
    # the capacity of the next top-down step
    scout = out_edges = int(g.degrees[source])
    edges_to_check = g.nnz
    depth = 0
    iters = 0
    while n_frontier > 0:
        if scout > edges_to_check // ALPHA:
            # bottom-up phase (omp_beamer.cc:137-149)
            awake = n_frontier
            while True:
                with span("bfs.level"):
                    iters += 1
                    old_awake = awake
                    dist, mask = _bu_dense_level(sweep, dist, mask, depth)
                    awake, out_edges = host_read(torch.stack(
                        [mask.sum(), frontier_degree_sum(mask, deg)]))
                    depth += 1
                if not (awake >= old_awake or awake > m // BETA):
                    break
            n_frontier = awake
            scout = 1
        else:
            with span("bfs.level"):
                iters += 1
                edges_to_check -= scout
                dist, mask = _td_level(rowptr, colidx, deg, dist, mask,
                                       depth, out_edges)
                n_frontier, scout = host_read(torch.stack(
                    [mask.sum(), frontier_degree_sum(mask, deg)]))
                out_edges = scout
                depth += 1
    return BFSResult(dist, iters)


def fused_tiers(m: int, nnz: int) -> List[Tuple[int, int]]:
    """The graduated (id, edge) capacities of do_fused's top-down and
    sparse bottom-up tiers (bfs.py:248-274): E/alpha snapped to a power of
    two and clamped at 512K, and that shifted down by 3 and 6 bits."""
    cap_t = min(T.next_pow2(max(nnz // ALPHA, 256)), 1 << 19)
    tiers = []
    for shift in (6, 3, 0):
        ce = max(1024, cap_t >> shift)
        ci = min(T.next_pow2(max(m, 2)), ce)
        if (ci, ce) not in tiers:
            tiers.append((ci, ce))
    return tiers


def _pick_branch(scout: int, work_bu: int, tiers) -> int:
    """The index the JAX solver's lax.switch takes (bfs.py:330-341): the
    smallest top-down tier that holds `scout` edges; beyond them the
    smallest sparse bottom-up tier that holds `work_bu`; else the dense
    sweep (index 2 * len(tiers))."""
    idx = sum(int(scout > ce) for _, ce in tiers)
    if idx == len(tiers):
        idx += sum(int(work_bu > ce) for _, ce in tiers)
    return idx


def bfs_do_fused(g, source: int, *, layout: str = "auto",
                 device="cuda") -> BFSResult:
    """Direction-optimizing BFS with the level's direction chosen from
    graduated tiers (see the module docstring); one read per level."""
    layout = _resolve_layout(layout)
    dev = resolve_device(device)
    gg, sweep, new_of_old = _count_sweep(g, layout, dev)
    m = gg.m
    rowptr, colidx = views.csr(gg, dev)
    deg = views.degrees(gg, dev)
    # bottom-up needs in-edges; a symmetric graph's are its out-edges (one
    # cache entry in core/views)
    rowptr_r, colidx_r = views.csr(gg, dev, reverse=True)
    deg_in = views.degrees(gg, dev, reverse=True)
    tiers = fused_tiers(m, gg.nnz)
    if new_of_old is not None:
        source = host_read(new_of_old[source])
    dist, mask = _start(m, source, dev)

    def state():
        # the one read that ends a level: whether a vertex is in the
        # frontier, its out-edges (scout) and the unvisited rows' in-edges
        return host_read(torch.stack(
            [mask.any().long(), frontier_degree_sum(mask, deg),
             torch.where(dist == INF, deg_in, 0).sum()]))

    depth = 0
    alive, scout, work_bu = state()
    while alive:
        with span("bfs.level"):
            idx = _pick_branch(scout, work_bu, tiers)
            if idx < len(tiers):
                dist, mask = _td_level(rowptr, colidx, deg, dist, mask,
                                       depth, scout)
            elif idx < 2 * len(tiers):
                dist, mask = _bu_sparse_level(rowptr_r, colidx_r, deg_in,
                                              dist, depth, work_bu)
            else:
                dist, mask = _bu_dense_level(sweep, dist, mask, depth)
            depth += 1
            alive, scout, work_bu = state()
    if new_of_old is not None:
        dist = dist[new_of_old]
    return BFSResult(dist, depth)


def bfs_multi_source(g, sources, *, layout: str = "auto",
                     device="cuda") -> BFSResult:
    """Batched multi-source BFS: S sources traverse at once in the last
    dimension (state (m, S)); returns dist of shape (m, S).  On the
    hybrid layout one pass over the dense panels serves all S sources
    (K1 on tensor cores) and only the remainder pays per-edge row gathers;
    the frontier goes over as a 0/1 bf16 mask, which is exact and halves
    the operand's bytes.  The 'ell' layout takes the per-edge path over
    the dst-sorted COO edges (ops/spmv.spmv_batched)."""
    layout = _resolve_layout(layout)
    dev = resolve_device(device)
    m = g.m
    sources = torch.from_numpy(np.asarray(sources, np.int64)).to(dev)
    S = sources.shape[0]
    if layout == "hybrid":
        from gardenia_tpu_torch.ops.bsr import spmv_hybrid_batched
        _, hyb, new_of_old = views.relabeled_hybrid(g, dev)
        sources = new_of_old[sources]

        def sweep(frontier):
            return spmv_hybrid_batched(hyb, frontier, num_rows=m)
    else:
        from gardenia_tpu_torch.ops.spmv import spmv_batched
        new_of_old = None
        in_dst, in_src = views.coo_sorted(g, dev, reverse=True)

        def sweep(frontier):
            return spmv_batched(in_dst, in_src, frontier, num_rows=m)
    dist = torch.full((m, S), INF, dtype=torch.int32, device=dev)
    dist[sources, torch.arange(S, device=dev)] = 0
    d = 0
    alive = True
    while alive:
        with span("bfs.level"):
            cnt = sweep((dist == d).to(torch.bfloat16))
            newly = (cnt > 0) & (dist == INF)
            dist = torch.where(newly, d + 1, dist)
            d += 1
            alive = host_read(newly.any())  # the level's one read
    if new_of_old is not None:
        dist = dist[new_of_old]             # (m, S) row gather
    return BFSResult(dist, d)


VARIANTS = {"pull": bfs_pull, "do": bfs_do, "do_fused": bfs_do_fused}


@spanned("solve.bfs")
def bfs_solver(g, source: int = 0, *, variant: str = "do",
               device="cuda") -> BFSResult:
    """Reference entry BFSSolver(g, source, dist) (src/bfs/bfs.h:43).
    Needs in-edges (need_reverse) for the pull and bottom-up steps."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown BFS variant {variant!r}")
    return VARIANTS[variant](g, source, device=device)
