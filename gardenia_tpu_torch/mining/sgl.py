"""SGL — subgraph listing for fixed patterns (diamond / rectangle /
pentagon / house); torch counterpart of gardenia_tpu/mining/sgl.py.

Reference: mining/sgl/{sgl.h,pattern.h,omp_base.cc} with per-pattern
AutoMine nests ({diamond,rectangle,pentagon,house}.h).  Every pattern
runs through the one declarative expansion engine (mining/pattern.py);
`diamond` also has a closed form, its default:

  diamonds = sum over undirected edges e of C(t(e), 2) - 6 K4

(a diamond's chord is the one edge whose two triangles it holds; each of
a 4-clique's 6 edges holds one such pair).  t(e), the triangles on each
undirected edge, comes from the wedge streams (mining/wedgestream.
wedge_stream_stats); where they raise StreamTooLarge, from the card's
wedge sweep `motif.edge_triangle_counts`, as motif_solver does.  K4 is
kcl_solver(g, 4) (kernel Q1).  The JAX formula halves its sum because its
t is per directed edge; this t is per undirected edge, so nothing halves.
`LAST_ROUTE` says what the last sgl_solver call ran: "route" (streams,
wedge_sweep or engine), "kcl_route", and on the formula the 4-cliques
"k4" and the triangles over the edges "tri_sum" (3T).
"""

from __future__ import annotations

import numpy as np

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.mining import kcl, motif, wedgestream
from gardenia_tpu_torch.mining.pattern import PATTERNS, count_pattern
from gardenia_tpu_torch.utils.profiler import spanned

LAST_ROUTE = None


def diamond_formula(g, device="cuda") -> int:
    """The diamonds of the symmetric graph g by the closed form."""
    global LAST_ROUTE
    dev = resolve_device(device)
    try:
        _, t, _, _ = wedgestream.wedge_stream_stats(g, device=dev)
        route = "streams"
    except wedgestream.StreamTooLarge:
        # one stream partition is too large: the wedge sweep has no cap
        src = np.repeat(np.arange(g.m, dtype=np.int64), np.diff(g.rowptr))
        t = motif.edge_triangle_counts(g, device=dev)[src < g.colidx]
        route = "wedge_sweep"
    t = np.asarray(t, np.int64)
    k4 = kcl.kcl_solver(g, 4, device=dev)
    LAST_ROUTE = {"route": route, "kcl_route": kcl.LAST_ROUTE, "k4": k4,
                  "tri_sum": int(t.sum())}
    return int((t * (t - 1) // 2).sum()) - 6 * k4


@spanned("solve.sgl")
def sgl_solver(g, pattern: str, *, use_formula: bool = True,
               device="cuda") -> int:
    """Reference entry SglSolver(g, pattern, total) (mining/sgl/sgl.h:15).
    g must be symmetric."""
    global LAST_ROUTE
    name = pattern.lower()
    if name == "diamond" and use_formula:
        return diamond_formula(g, device)
    if name not in PATTERNS:
        raise ValueError(f"unknown pattern {pattern!r}; "
                         f"available: {sorted(PATTERNS)}")
    LAST_ROUTE = {"route": "engine", "kcl_route": None}
    return count_pattern(g, PATTERNS[name], device=device)


def sgl_verifier(g, pattern: str) -> int:
    """Brute-force oracle over vertex subsets (test sizes only)."""
    import itertools
    import numpy as np
    m = g.m
    rp, ci = g.rowptr, g.colidx
    adj = [set(ci[rp[v]:rp[v + 1]].tolist()) for v in range(m)]

    def has(a, b):
        return b in adj[a]

    count = 0
    if pattern == "diamond":
        for sub in itertools.combinations(range(m), 4):
            edges = [(a, b) for a, b in itertools.combinations(sub, 2)
                     if has(a, b)]
            degs = sorted(sum(1 for x in sub if has(v, x)) for v in sub)
            if len(edges) == 5 and degs == [2, 2, 3, 3]:
                count += 1
        return count
    if pattern == "rectangle":
        for sub in itertools.combinations(range(m), 4):
            edges = sum(1 for a, b in itertools.combinations(sub, 2)
                        if has(a, b))
            degs = sorted(sum(1 for x in sub if has(v, x)) for v in sub)
            if edges == 4 and degs == [2, 2, 2, 2]:
                count += 1
        return count
    if pattern == "pentagon":
        for sub in itertools.combinations(range(m), 5):
            edges = sum(1 for a, b in itertools.combinations(sub, 2)
                        if has(a, b))
            degs = sorted(sum(1 for x in sub if has(v, x)) for v in sub)
            if edges == 5 and degs == [2, 2, 2, 2, 2]:
                count += 1
        return count
    if pattern == "house":
        for sub in itertools.combinations(range(m), 5):
            edges = sum(1 for a, b in itertools.combinations(sub, 2)
                        if has(a, b))
            degsv = {v: sum(1 for x in sub if has(v, x)) for v in sub}
            degs = sorted(degsv.values())
            if edges == 6 and degs == [2, 2, 2, 3, 3]:
                # distinguish from K_{2,3}: the house's two degree-3
                # vertices are adjacent (the chord)
                d3 = [v for v in sub if degsv[v] == 3]
                if has(d3[0], d3[1]):
                    count += 1
        return count
    raise ValueError(pattern)
