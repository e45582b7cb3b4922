"""Motif — k-motif counting (connected induced-pattern census); torch
counterpart of gardenia_tpu/mining/motif.py (reference mining/motif_dfs/
{omp_base.cc,omp_formula.cc,ccode_formula.h}).  The formula variant
derives the census from aggregates instead of enumerating embeddings.

Induced counts via Moebius inversion over non-induced counts
(ESCAPE-style identities, each held to a brute-force census by the
tests):

  3-census: W = sum_v C(deg,2);  T = triangles
    wedge(path-3)  = W - 3T
  4-census, from per-edge triangle counts t(e), codegrees, K4:
    D_non  = sum_e C(t(e), 2)                 (triangle pairs per edge)
    C_non  = sum_{u<w} C(codeg(u,w), 2) / 2   (cycle quadruples)
    TT_non = sum_v tri(v) * (deg(v) - 2)
    S_non  = sum_v C(deg(v), 3)
    P_non  = sum_e (deg(u)-1)(deg(v)-1) - 3T
    clique  K4    = kcl(4)
    diamond D     = D_non - 6 K4
    cycle   C4    = C_non - D_non + 3 K4
    tailed  TT    = TT_non - 4 D - 12 K4
    claw    S     = S_non - TT - 2 D - 4 K4
    path    P4    = P_non - 2 TT - 4 C4 - 6 D - 12 K4

T comes from tc_solver (kernels K3, K4, H1), K4 from kcl_solver (kernel
Q1), t(e) and C_non from the wedge streams (mining/wedgestream.py); where
those raise StreamTooLarge (a partition too large) the host oracles
`edge_triangle_counts` and `codegree_cycle_quads` take their place.
`LAST_AGGREGATES` says which ran in the last 4-census ("streams" or
"host_oracles") and the sum of its t(e) (3T).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.mining.kcl import (EMB_WEDGE_LIMIT, _member,
                                           kcl_solver, search_rounds,
                                           wedge_slices)
from gardenia_tpu_torch.solvers.tc import tc_solver

LAST_AGGREGATES = None


def edge_triangle_counts(g, chunk: int = 1 << 20,
                         device="cuda") -> np.ndarray:
    """tri(e) = |N(u) ∩ N(v)| per DIRECTED edge slot of the symmetric
    graph (both directions carry the same count), int64: a wedge sweep
    with binary-search membership (kcl._member), added per edge by
    index_add_."""
    m, nnz = g.m, g.nnz
    if nnz == 0:
        return np.zeros(0, np.int64)
    dev = resolve_device(device)
    deg = np.diff(g.rowptr)
    rowptr = torch.from_numpy(np.asarray(g.rowptr, np.int64)).to(dev)
    colidx = torch.from_numpy(np.asarray(g.colidx, np.int64)).to(dev)
    src = torch.repeat_interleave(
        torch.arange(m, device=dev), rowptr[1:] - rowptr[:-1])
    wpe_h = deg[np.repeat(np.arange(m), deg)].astype(np.int64)
    wpe = torch.from_numpy(wpe_h).to(dev)
    rounds = search_rounds(deg.max())
    tri = torch.zeros(nnz, dtype=torch.int64, device=dev)
    for lo, hi in wedge_slices(wpe_h, EMB_WEDGE_LIMIT):
        cum = torch.cumsum(wpe[lo:hi], 0)
        total = int(cum[-1])
        for start in range(0, total, chunk):
            j = torch.arange(start, min(total, start + chunk),
                             dtype=torch.int64, device=dev)
            e = torch.searchsorted(cum, j, right=True)
            k = j - (cum[e] - wpe[lo + e])
            u, v = src[lo + e], colidx[lo + e]
            w = colidx[rowptr[u] + k]
            found = (w != v) & _member(rowptr, colidx, nnz, w, v, rounds)
            tri.index_add_(0, lo + e, found.long())
    return tri.cpu().numpy()


def codegree_cycle_quads(g, pass_budget: int = 200_000_000) -> int:
    """C_non = sum over unordered non-center pairs of C(codeg, 2) / 2.

    Enumerates wedges per center and counts duplicate endpoint pairs
    (vectorized unranking + sort).  The wedge space is Theta(sum deg^2);
    when it exceeds `pass_budget` the pair space is hash-partitioned by
    the smaller endpoint (u mod P) and enumerated in P passes, so peak
    memory stays ~pass_budget while any wedge total is exact — the
    multi-pass analog of the reference's bounded embedding queues
    (include/mining/embedding.h)."""
    m = g.m
    deg = np.diff(g.rowptr).astype(np.int64)
    pairs_per_v = deg * (deg - 1) // 2
    wedge_total = int(pairs_per_v.sum())
    if wedge_total == 0:
        return 0
    n_pass = max(1, -(-wedge_total // pass_budget))
    rp, ci = g.rowptr, np.asarray(g.colidx, dtype=np.int64)
    cum = np.cumsum(pairs_per_v)
    base = cum - pairs_per_v

    def wedge_endpoints(lo: int, hi: int):
        """Vectorized unranking of wedge slots [lo, hi) -> (u, w) with
        u < w (neighbor lists are sorted): global pair slot q ->
        (center v, unordered slot pair i<j)."""
        v_lo = np.searchsorted(cum, lo, side="right")
        v_hi = np.searchsorted(cum, hi - 1, side="right") + 1
        ppv = pairs_per_v[v_lo:v_hi].copy()
        # clip the first/last center's pair range to [lo, hi)
        v = np.repeat(np.arange(v_lo, v_hi, dtype=np.int64), ppv)
        q = np.arange(base[v_lo], base[v_lo] + len(v), dtype=np.int64) \
            - base[v]
        sel = (q + base[v] >= lo) & (q + base[v] < hi)
        v, q = v[sel], q[sel]
        d = deg[v]
        # unrank with a float estimate then exact fix-up (float64 sqrt
        # can be off by 1)
        i = ((2 * d - 1) - np.sqrt((2 * d - 1) ** 2 - 8 * q)) // 2
        i = i.astype(np.int64)

        def start_of(i):
            return i * (2 * d - i - 1) // 2

        i = np.where(start_of(i) > q, i - 1, i)
        i = np.where(start_of(i + 1) <= q, i + 1, i)
        j = q - start_of(i) + i + 1
        return ci[rp[v] + i], ci[rp[v] + j]

    def count_dups(keys: np.ndarray) -> int:
        if not len(keys):
            return 0
        keys.sort(kind="stable")
        boundary = np.empty(len(keys), bool)
        boundary[0] = True
        np.not_equal(keys[1:], keys[:-1], out=boundary[1:])
        starts = np.nonzero(boundary)[0]
        counts = np.diff(np.concatenate([starts, [len(keys)]]))
        return int((counts * (counts - 1) // 2).sum())

    if n_pass == 1:
        u, w = wedge_endpoints(0, wedge_total)
        return count_dups(u * m + w) // 2

    # multi-pass: pass p keeps pairs with u % n_pass == p (all wedges of
    # a pair land in one pass, so per-pass duplicate counts are exact)
    total = 0
    chunk = max(1 << 20, pass_budget // 4)
    for p in range(n_pass):
        parts = []
        for lo in range(0, wedge_total, chunk):
            u, w = wedge_endpoints(lo, min(lo + chunk, wedge_total))
            keep = (u % n_pass) == p
            if keep.any():
                parts.append(u[keep] * m + w[keep])
        if parts:
            total += count_dups(np.concatenate(parts))
    return total // 2


def motif_solver(g, k: int = 3, device="cuda") -> Dict[str, int]:
    """Reference entry MotifSolver (mining/motif_dfs).  g symmetric.
    Returns the induced census dict for k in {3, 4}."""
    global LAST_AGGREGATES
    dev = resolve_device(device)
    deg = np.diff(g.rowptr).astype(np.int64)
    t3 = tc_solver(g, device=dev)
    if k == 3:
        wedges = int((deg * (deg - 1) // 2).sum())
        return {"3-path": wedges - 3 * t3, "3-triangle": t3}
    if k != 4:
        raise ValueError("motif_solver supports k in {3, 4}")
    k4 = kcl_solver(g, 4, device=dev)
    src = np.repeat(np.arange(g.m, dtype=np.int64), np.diff(g.rowptr))
    dst = np.asarray(g.colidx, dtype=np.int64)
    from gardenia_tpu_torch.mining import wedgestream
    try:
        c_non, d_non, tri_v, tri_u = wedgestream.motif4_aggregates(
            g, device=dev)
        branch = "streams"
    except wedgestream.StreamTooLarge:
        # one stream partition is too large: the host oracles have no cap
        t = edge_triangle_counts(g, device=dev)[src < dst]
        c_non = codegree_cycle_quads(g)
        d_non = int((t * (t - 1) // 2).sum())
        tri_v = np.zeros(g.m, np.int64)
        np.add.at(tri_v, src[src < dst], t)
        np.add.at(tri_v, dst[src < dst], t)
        tri_v //= 2
        tri_u, branch = t, "host_oracles"
    LAST_AGGREGATES = {"aggregates": branch,
                       "tri_sum": int(np.sum(tri_u, dtype=np.int64))}
    tt_non = int((tri_v * (deg - 2)).sum())
    s_non = int((deg * (deg - 1) * (deg - 2) // 6).sum())
    p_non = int(((deg[src] - 1) * (deg[dst] - 1)).sum()) // 2 - 3 * t3

    diamond = d_non - 6 * k4
    cycle4 = c_non - d_non + 3 * k4
    tailed = tt_non - 4 * diamond - 12 * k4
    claw = s_non - tailed - 2 * diamond - 4 * k4
    path4 = p_non - 2 * tailed - 4 * cycle4 - 6 * diamond - 12 * k4
    return {"4-path": path4, "4-star": claw, "4-cycle": cycle4,
            "4-tailed-triangle": tailed, "4-diamond": diamond,
            "4-clique": k4}


def motif_census_bruteforce(g, k: int) -> Dict[str, int]:
    """Brute-force induced census oracle for tests (k=3 or 4)."""
    import itertools
    m = g.m
    rp, ci = g.rowptr, g.colidx
    adj = [set(ci[rp[v]:rp[v + 1]].tolist()) for v in range(m)]

    def etype(sub):
        edges = sum(1 for a, b in itertools.combinations(sub, 2)
                    if b in adj[a])
        degs = sorted(sum(1 for b in sub if b in adj[a] and b != a)
                      for a in sub)
        return edges, tuple(degs)

    counts: Dict[str, int] = {}
    if k == 3:
        names = {(2, (1, 1, 2)): "3-path", (3, (2, 2, 2)): "3-triangle"}
        for sub in itertools.combinations(range(m), 3):
            key = etype(sub)
            if key in names:
                counts[names[key]] = counts.get(names[key], 0) + 1
        for v in names.values():
            counts.setdefault(v, 0)
        return counts
    names = {
        (3, (1, 1, 2, 2)): "4-path",
        (3, (1, 1, 1, 3)): "4-star",
        (4, (2, 2, 2, 2)): "4-cycle",
        (4, (1, 2, 2, 3)): "4-tailed-triangle",
        (5, (2, 2, 3, 3)): "4-diamond",
        (6, (3, 3, 3, 3)): "4-clique",
    }
    for sub in itertools.combinations(range(m), 4):
        key = etype(sub)
        if key in names:
            counts[names[key]] = counts.get(names[key], 0) + 1
    for v in names.values():
        counts.setdefault(v, 0)
    return counts
