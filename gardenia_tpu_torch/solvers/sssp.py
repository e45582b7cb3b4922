"""SSSP — delta-stepping and Bellman-Ford over min-plus SpMV; torch
counterpart of gardenia_tpu/solvers/sssp.py (reference src/sssp/{sssp.h,
omp_base.cc,dstep.cu,davidson.cu}).

Distances are int32 with the MYINFINITY (1e9) sentinel; MYINFINITY plus
any edge weight stays below 2^31, so min-plus over the sentinel needs no
mask (common.h:66).  Edge weights are the graph's, cast f32 -> int32
(truncation), or 1 when it has none.

Variants:
  'bf'      — frontier Bellman-Ford: relax out of every vertex whose
              distance improved last round.
  'delta'   — delta-stepping: relax only the frontier vertices of the
              lowest occupied bucket (dist // delta); improved vertices
              re-enter their bucket until it drains.
  'hybrid'  — the same rounds as 'delta' (sssp_hybrid, which the JAX
              package already drives from the host).
  'nearfar' — near-far delta-stepping on compact queues
              (solvers/sssp_nf.py).
A round relaxes its active vertices by a compacted expansion of their
out-edges and a scatter-min when they have at most nnz // alpha out-edges
(alpha = 15), else by a dense masked min-plus sweep over the weighted
in-ELL.

The JAX solver fuses its rounds in one lax.while_loop with lax.cond
choosing the branch.  Here the loop runs on the host and reads back once
a round: the active count and their out-edge count (scout), in one
packed read.  The branch rule is the JAX package's, so every round takes
the same branch and `iterations` match; the sparse branch's capacity is
the round's exact edge count, where the JAX solver pads it to a power of
two, which changes no result.  The JAX signature's `segment_rounds` and
`checkpointer` (host segmentation for the TPU worker's program kill) are
not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.core import views
from gardenia_tpu_torch.ops.frontier import (compact_mask,
                                             expand_frontier_edges)
from gardenia_tpu_torch.ops.semiring import I32_MIN_PLUS
from gardenia_tpu_torch.ops.spmv import spmv_ell
from gardenia_tpu_torch.utils.profiler import spanned

INF = int(T.MYINFINITY)
ALPHA = 15
VARIANTS = ("delta", "bf", "hybrid", "nearfar")


@dataclasses.dataclass
class SSSPResult:
    dist: torch.Tensor      # i32[m]; INF = unreachable
    iterations: int


@dataclasses.dataclass
class Relaxer:
    """A graph's relaxation operators on one device."""
    m: int
    rowptr: torch.Tensor    # i64[m + 1]
    colidx: torch.Tensor    # i32[nnz]
    wi: torch.Tensor        # i32[nnz] weights in CSR order
    deg: torch.Tensor       # i32[m] out-degrees
    in_ell: object          # ops/ell.EllMatrix of the transpose, weighted

    @classmethod
    def of(cls, g, dev) -> "Relaxer":
        rowptr, colidx = views.csr(g, dev)
        # min-plus takes int weights: the f32 in-ELL computes in int32
        # (weights below 2^24 are exact in f32)
        return cls(g.m, rowptr, colidx,
                   views.edge_weights(g, dev, torch.int32),
                   views.degrees(g, dev),
                   views.ell(g, dev, reverse=True, weighted=True))

    def edges(self, dist, ids, n_edges: int):
        """(dst, nd) over the out-edges of `ids` (no padding), in CSR
        order per id: nd = dist[src] + w, the candidate distance."""
        src, dst, _, eid = expand_frontier_edges(self.rowptr, self.colidx,
                                                 ids, n_edges)
        return dst, dist[src.long()] + self.wi[eid]

    def sparse(self, dist, ids, n_edges: int) -> torch.Tensor:
        """dist with the out-edges of `ids` relaxed by a scatter-min."""
        if n_edges == 0:
            return dist
        dst, nd = self.edges(dist, ids, n_edges)
        return dist.scatter_reduce(0, dst.long(), nd, "amin")

    def dense(self, dist, active=None) -> torch.Tensor:
        """dist relaxed over every in-edge whose source is active (all
        sources when active is None): the min-plus sweep."""
        x = dist if active is None else torch.where(active, dist, INF)
        return torch.minimum(dist, spmv_ell(self.in_ell, x,
                                            semiring=I32_MIN_PLUS,
                                            num_rows=self.m))


def _start(m: int, source: int, dev):
    dist = torch.full((m,), INF, dtype=torch.int32, device=dev)
    dist[source] = 0
    frontier = torch.zeros(m, dtype=torch.bool, device=dev)
    frontier[source] = True
    return dist, frontier


def _bucket_rounds(g, source: int, delta: int, *, use_delta: bool,
                   threshold: int, max_rounds: float, dev) -> SSSPResult:
    """The rounds of 'delta', 'bf' and 'hybrid' (gardenia_tpu/solvers/
    sssp.py:57-104 and 107-185): a round takes the sparse branch when
    its active vertices' out-edges number at most `threshold`."""
    r = Relaxer.of(g, dev)
    dist, frontier = _start(g.m, source, dev)
    rounds = 0
    while rounds < max_rounds:
        if use_delta:
            bucket = torch.where(frontier, dist // delta, INF).min()
            active = frontier & (dist // delta == bucket)
        else:
            active = frontier
        n_active, scout = (int(v) for v in torch.stack([
            active.sum(), torch.where(active, r.deg, 0).sum()]).tolist())
        if n_active == 0:              # the frontier is empty
            break
        rounds += 1
        if scout <= threshold:
            new = r.sparse(dist, compact_mask(active, n_active, g.m), scout)
        else:
            new = r.dense(dist, active)
        frontier = (frontier & ~active) | (new < dist)
        dist = new
    return SSSPResult(dist, rounds)


def sssp_hybrid(g, source: int = 0, delta: int = 1, *,
                max_rounds: int = None, device="cuda") -> SSSPResult:
    """Frontier-size-adaptive delta-stepping (gardenia_tpu/solvers/
    sssp.py:107-185): a bucket with at most max(1, nnz // ALPHA)
    out-edges expands its compacted out-edges and scatter-mins, a wider
    one takes the dense masked min-plus sweep.  Runs until the buckets
    drain, or for at most `max_rounds` rounds when that is given."""
    return _bucket_rounds(g, source, max(1, int(delta)), use_delta=True,
                          threshold=max(1, g.nnz // ALPHA),
                          max_rounds=(float("inf") if max_rounds is None
                                      else max_rounds),
                          dev=resolve_device(device))


@spanned("solve.sssp")
def sssp_solver(g, source: int = 0, delta: int = 1, *,
                variant: str = "delta", max_rounds: int = None,
                device="cuda") -> SSSPResult:
    """Reference entry SSSPSolver(g, source, weight, dist, delta)
    (src/sssp/sssp.h:46); int32 distances on `device`."""
    dev = resolve_device(device)
    if variant not in VARIANTS:
        raise ValueError(f"unknown SSSP variant {variant!r} "
                         f"({', '.join(VARIANTS)})")
    if variant == "hybrid":
        return sssp_hybrid(g, source, delta, max_rounds=max_rounds,
                           device=dev)
    if variant == "nearfar":
        from gardenia_tpu_torch.solvers.sssp_nf import sssp_nearfar
        return sssp_nearfar(g, source, delta, max_rounds=max_rounds,
                            device=dev)
    if max_rounds is None:
        # worst case: every round settles at least one vertex
        max_rounds = 4 * g.m + 16
    return _bucket_rounds(g, source, max(1, int(delta)),
                          use_delta=variant == "delta",
                          threshold=g.nnz // ALPHA, max_rounds=max_rounds,
                          dev=dev)
