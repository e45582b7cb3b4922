"""The plain weighted reference for SSSP: the same graph, cleaned and
solved in plain PyTorch, independent of the port (nothing of
gardenia_tpu_torch is imported, nothing the port made is read).

It takes the benchmark's raw weighted edge list (generators/), builds its
own weighted CSR by one sort of packed keys, and answers single-source
shortest paths by Bellman-Ford run to its fixed point:

  weighted_csr — symmetrized when asked, self-loops dropped, and each
                 (u, v) pair given the least weight over its raw edges in
                 either direction (the configuration's stated rule);
  distances    — Jacobi relax rounds over every arc, each candidate
                 dist[u] + w scatter-min'd into dist[v] (int64), until a
                 round changes nothing; -1 = unreached.

The arguments of `distances` that depart from that (`round_to`,
`max_rounds`) exist for the controls (kernels/sssp.py): the same formula
a step below what the configuration states.
"""

from __future__ import annotations

import dataclasses

import torch

# above any distance a graph of int32 weights can have, and far enough
# below int64's top that INF + a weight does not wrap
INF = 1 << 62


@dataclasses.dataclass
class WeightedGraph:
    m: int
    rowptr: torch.Tensor     # int64[m + 1]
    rows: torch.Tensor       # int64[arcs], non-decreasing
    cols: torch.Tensor       # int64[arcs], ascending within a row
    weights: torch.Tensor    # int64[arcs]

    @property
    def degrees(self) -> torch.Tensor:
        return self.rowptr[1:] - self.rowptr[:-1]


def weighted_csr(m: int, src: torch.Tensor, dst: torch.Tensor,
                 wt: torch.Tensor, symmetrize: bool = True
                 ) -> WeightedGraph:
    """Weighted CSR of the raw edges: symmetrized when asked, self-loops
    removed, one arc a (u, v) pair carrying the least of its duplicates'
    weights, rows and columns sorted.  Weights are whole numbers (GAP's
    1..255) and kept as int64."""
    s, d = src.to(torch.int64), dst.to(torch.int64)
    w = wt.to(torch.int64)
    if symmetrize:
        s, d, w = torch.cat([s, d]), torch.cat([d, s]), torch.cat([w, w])
    keep = s != d
    key, inverse = torch.unique(s[keep] * m + d[keep], return_inverse=True)
    weights = torch.full(key.shape, INF, dtype=torch.int64,
                         device=key.device)
    weights.scatter_reduce_(0, inverse, w[keep], "amin")
    del s, d, w, keep, inverse
    rows, cols = key // m, key % m
    rowptr = torch.zeros(m + 1, dtype=torch.int64, device=key.device)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    return WeightedGraph(m, rowptr, rows, cols, weights)


def distances(g: WeightedGraph, source: int, *, round_to=None,
              max_rounds: int = None):
    """(int64[m] shortest-path distances from `source`, -1 where
    unreached; the relax rounds that changed a distance).  Each round
    relaxes every arc from the distances of the round before, so the
    rounds are the most arcs on any shortest path the relaxation needs.
    With `round_to` (a floating dtype) each candidate dist[u] + w is
    rounded to it before the min; with `max_rounds` the relaxation stops
    after that many rounds, at the fixed point or not."""
    dist = torch.full((g.m,), INF, dtype=torch.int64, device=g.cols.device)
    dist[source] = 0
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        cand = dist[g.rows] + g.weights
        if round_to is not None:
            cand = torch.where(cand < INF, cand.to(round_to).to(torch.int64),
                               cand)
        new = dist.scatter_reduce(0, g.cols, cand, "amin")
        if torch.equal(new, dist):
            break
        dist = new
        rounds += 1
    return torch.where(dist >= INF, -1, dist), rounds


def reached_arcs(g: WeightedGraph, dist: torch.Tensor) -> int:
    """The arcs out of the vertices that `dist` reaches."""
    return int(g.degrees[dist >= 0].sum())
