"""The plain reference: the same graph, cleaned and solved in plain
PyTorch, independent of the port (nothing of gardenia_tpu_torch is
imported, nothing the port made is read).

It takes the benchmark's raw edge list (generators/), builds its own
CSR by one sort of packed keys, and answers PageRank, BFS and triangle
counting by the textbook formulas:

  pagerank   — pull power iteration, damping 0.85, initial scores 1/|V|,
               contributions score/out-degree (0 where the degree is 0),
               stop at the first iteration whose L1 change is under
               epsilon (GAP pr.cc, GARDENIA pr.h);
  bfs        — level-synchronous top-down expansion; -1 = unreached;
  triangles  — the degree-ordered DAG (u -> v iff (deg u, u) < (deg v,
               v)); for each arc (u, v) and each w in N+(u), one lookup of
               the key (v, w) among the DAG's sorted keys.

The precision arguments exist for the controls (kernels/*.py): the same
formulas a step below what the configuration states.
"""

from __future__ import annotations

import dataclasses

import torch

KDAMP = 0.85


@dataclasses.dataclass
class RefGraph:
    m: int
    rowptr: torch.Tensor     # int64[m + 1]
    rows: torch.Tensor       # int64[arcs], non-decreasing
    cols: torch.Tensor       # int64[arcs], ascending within a row

    @property
    def arcs(self) -> int:
        return int(self.cols.numel())

    @property
    def degrees(self) -> torch.Tensor:
        return self.rowptr[1:] - self.rowptr[:-1]

    def stats(self) -> dict:
        deg = self.degrees
        return {"vertices": self.m, "arcs": self.arcs,
                "dag_edges": self.arcs // 2,
                "nonzero_degree": int((deg > 0).sum()),
                "max_degree": int(deg.max()) if self.m else 0}


def clean_csr(m: int, src: torch.Tensor, dst: torch.Tensor,
              symmetrize: bool = True) -> RefGraph:
    """CSR of the raw edges: symmetrized when asked, self-loops and
    duplicates removed, rows and columns sorted."""
    s, d = src.to(torch.int64), dst.to(torch.int64)
    if symmetrize:
        s, d = torch.cat([s, d]), torch.cat([d, s])
    keep = s != d
    key = torch.unique(s[keep] * m + d[keep])       # sorted
    del s, d, keep
    rows, cols = key // m, key % m
    rowptr = torch.zeros(m + 1, dtype=torch.int64, device=key.device)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m), 0)
    return RefGraph(m, rowptr, rows, cols)


def pagerank(g: RefGraph, epsilon: float, *, keep=(), keep_stop=False,
             max_iter: int = 100, value_dtype=torch.float64,
             operand_dtype=None):
    """Pull PageRank: ({k: scores after iteration k for k in keep, and
    for the stopping iteration with keep_stop}, the L1 change of every
    iteration run, the first iteration whose change is under epsilon).
    It runs at least max(keep) iterations.  With
    `operand_dtype` the contributions are rounded to it before they are
    summed (in value_dtype)."""
    m = g.m
    deg = g.degrees.to(value_dtype)
    has_out = deg > 0
    safe = deg.clamp(min=1)
    scores = torch.full((m,), 1.0 / m, dtype=value_dtype,
                        device=g.cols.device)
    base = (1.0 - KDAMP) / m
    need = max(keep, default=0)
    kept, errs, stop = {}, [], None
    while len(errs) < max_iter and (stop is None or len(errs) < need):
        contrib = torch.where(has_out, scores / safe, 0.0)
        if operand_dtype is not None:
            contrib = contrib.to(operand_dtype).to(value_dtype)
        incoming = torch.zeros_like(scores).index_add_(0, g.cols,
                                                       contrib[g.rows])
        new = base + KDAMP * incoming
        errs.append(float((new - scores).abs().sum()))
        scores = new
        if len(errs) in keep:
            kept[len(errs)] = scores.clone()
        if stop is None and errs[-1] < epsilon:
            stop = len(errs)
            if keep_stop:
                kept[stop] = scores.clone()
    if stop is None:
        stop = len(errs)
        if keep_stop:
            kept[stop] = scores.clone()
    return kept, errs, stop


def bfs(g: RefGraph, source: int, *, drop_last_level: bool = False
        ) -> torch.Tensor:
    """int64[m] hop depths from `source`, -1 where unreached.  With
    drop_last_level the deepest level is left unreached (a BFS that stops
    one level early)."""
    dev = g.cols.device
    dist = torch.full((g.m,), -1, dtype=torch.int64, device=dev)
    dist[source] = 0
    frontier = torch.tensor([source], dtype=torch.int64, device=dev)
    depth = 0
    while frontier.numel():
        starts = g.rowptr[frontier]
        lens = g.rowptr[frontier + 1] - starts
        total = int(lens.sum())
        if total == 0:
            break
        offs = torch.cumsum(lens, 0) - lens
        idx = (torch.repeat_interleave(starts - offs, lens, output_size=total)
               + torch.arange(total, device=dev))
        nbrs = g.cols[idx]
        nbrs = torch.unique(nbrs[dist[nbrs] < 0])
        depth += 1
        dist[nbrs] = depth
        frontier = nbrs
    if drop_last_level and depth > 0:
        last = int(dist.max())
        dist[dist == last] = -1
    return dist


def dag(g: RefGraph):
    """(rowptr, rows, cols) of the degree-ordered DAG of a symmetric g."""
    deg = g.degrees
    du, dv = deg[g.rows], deg[g.cols]
    up = (du < dv) | ((du == dv) & (g.rows < g.cols))
    rows, cols = g.rows[up], g.cols[up]
    rowptr = torch.zeros(g.m + 1, dtype=torch.int64, device=rows.device)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=g.m), 0)
    return rowptr, rows, cols


def triangles(g: RefGraph, *, accumulate=torch.int64,
              chunk: int = 1 << 25) -> int:
    """Triangles of a symmetric g, each counted once.  The hits of each
    chunk of wedges are summed and the chunk sums accumulated in
    `accumulate` (int64 exact; float32 for the control)."""
    rowptr, rows, cols = dag(g)
    m = g.m
    keys = rows * m + cols                        # ascending
    outdeg = rowptr[1:] - rowptr[:-1]
    per_arc = outdeg[rows]                        # wedges of arc (u, v)
    first = torch.zeros(len(rows) + 1, dtype=torch.int64, device=rows.device)
    first[1:] = torch.cumsum(per_arc, 0)
    total_wedges = int(first[-1])
    if total_wedges == 0:
        return 0
    acc = torch.zeros((), dtype=accumulate, device=rows.device)
    for lo in range(0, total_wedges, chunk):
        j = torch.arange(lo, min(total_wedges, lo + chunk),
                         device=rows.device)
        e = torch.searchsorted(first, j, right=True) - 1
        u, v = rows[e], cols[e]
        w = cols[rowptr[u] + (j - first[e])]
        q = v * m + w
        pos = torch.searchsorted(keys, q).clamp(max=len(keys) - 1)
        hits = keys[pos] == q
        acc += hits.sum(dtype=accumulate)
    return int(round(float(acc))) if accumulate.is_floating_point \
        else int(acc)
