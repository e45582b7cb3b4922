"""Serial (NumPy) oracles, one per kernel — the reference ships one
verifier.cc per benchmark (SURVEY.md §4) and we reproduce each oracle's
algorithm here.  Oracles are intentionally simple and independent of the
TPU solvers; tests and CLI runs compare solver output against them."""

from __future__ import annotations

import heapq
from typing import Optional, Tuple

import numpy as np

from gardenia_tpu_torch.core import types as T


def _neigh(g, v, reverse=False):
    rp = g.in_rowptr if reverse else g.rowptr
    ci = g.in_colidx if reverse else g.colidx
    return ci[rp[v]:rp[v + 1]]


def spmv_serial(g, Ax: np.ndarray, x: np.ndarray,
                y: Optional[np.ndarray] = None) -> np.ndarray:
    """y += A x row-serially (src/spmv/spmv_util.h:31-43)."""
    y = np.zeros(g.m, np.float64) if y is None else y.astype(np.float64)
    src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    np.add.at(y, src, np.asarray(Ax, np.float64) *
              np.asarray(x, np.float64)[g.colidx])
    return y


def pagerank_serial(g, epsilon: float = 1e-4, kdamp: float = 0.85,
                    max_iter: int = 100) -> Tuple[np.ndarray, int, list]:
    """Serial pull PageRank (src/pr/verifier.cc:8-38). Divides by
    OUT-degree, pulls over in-neighbors."""
    m = g.m
    scores = np.full(m, 1.0 / m, np.float32)
    base = np.float32((1.0 - kdamp) / m)
    out_deg = g.degrees.astype(np.float32)
    in_rp, in_ci = g.in_rowptr, g.in_colidx
    dst = np.repeat(np.arange(m), np.diff(in_rp))
    errors = []
    it = 0
    for it in range(max_iter):
        contrib = np.divide(scores, out_deg, out=np.zeros(m, np.float32),
                            where=out_deg > 0)
        incoming = np.zeros(m, np.float32)
        np.add.at(incoming, dst, contrib[in_ci])
        new_scores = base + np.float32(kdamp) * incoming
        err = float(np.abs(new_scores - scores).sum())
        errors.append(err)
        scores = new_scores
        if err < epsilon:
            break
    return scores, it + 1, errors


def pagerank_push_residual(g, scores, kdamp: float = 0.85) -> float:
    """One push-direction iteration residual (src/pr/verifier.cc:40-51):
    returns sum |base + kdamp*incoming - scores|."""
    m = g.m
    base = (1.0 - kdamp) / m
    out_deg = g.degrees.astype(np.float64)
    contrib = np.where(out_deg > 0, np.asarray(scores, np.float64) / out_deg,
                       0)
    incoming = np.zeros(m, np.float64)
    src = np.repeat(np.arange(m), np.diff(g.rowptr))
    np.add.at(incoming, g.colidx, contrib[src])
    new = base + kdamp * incoming
    return float(np.abs(new - np.asarray(scores, np.float64)).sum())


def bfs_serial(g, source: int) -> np.ndarray:
    """Serial BFS depths (src/bfs/verifier.cc:8-40); unreachable =
    MYINFINITY (the reference verifier inits depth to MYINFINITY)."""
    depth = np.full(g.m, -1, T.DIST_DTYPE)
    depth[source] = 0
    frontier = [source]
    d = 0
    while frontier:
        d += 1
        nxt = []
        for u in frontier:
            for v in _neigh(g, u):
                if depth[v] < 0:
                    depth[v] = d
                    nxt.append(v)
        frontier = nxt
    depth[depth < 0] = T.MYINFINITY
    return depth


def sssp_serial(g, source: int) -> np.ndarray:
    """Serial Dijkstra (src/sssp/verifier.cc:8-50); unreachable =
    MYINFINITY."""
    wts = g.weights if g.weights is not None else np.ones(g.nnz)
    dist = np.full(g.m, T.MYINFINITY, np.int64)
    dist[source] = 0
    pq = [(0, source)]
    rp, ci = g.rowptr, g.colidx
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for e in range(rp[u], rp[u + 1]):
            v = ci[e]
            nd = d + int(wts[e])
            if nd < dist[v]:
                dist[v] = nd
                heapq.heappush(pq, (nd, v))
    return dist.astype(T.DIST_DTYPE)


def cc_serial(g) -> np.ndarray:
    """Connected-component labels by BFS flood (src/cc/verifier.cc);
    label = smallest vertex id in component.  Treats edges as undirected
    for verification (reference CC requires symmetrized input)."""
    comp = np.full(g.m, -1, T.COMP_DTYPE)
    both = g.symmetric
    for s in range(g.m):
        if comp[s] >= 0:
            continue
        comp[s] = s
        stack = [s]
        while stack:
            u = stack.pop()
            nbrs = _neigh(g, u) if both else np.concatenate(
                [_neigh(g, u), _neigh(g, u, reverse=True)])
            for v in nbrs:
                if comp[v] < 0:
                    comp[v] = s
                    stack.append(v)
    return comp


def bc_serial(g, source: int) -> np.ndarray:
    """Serial Brandes from one source, scores normalized by max
    (src/bc/omp_base.cc:14-110, src/bc/verifier.cc)."""
    m = g.m
    scores = np.zeros(m, np.float32)
    # forward BFS computing sigma (path counts) and depth
    depth = np.full(m, -1, np.int64)
    sigma = np.zeros(m, np.float64)
    depth[source] = 0
    sigma[source] = 1
    levels = [[source]]
    while levels[-1]:
        nxt = []
        for u in levels[-1]:
            for v in _neigh(g, u):
                if depth[v] < 0:
                    depth[v] = depth[u] + 1
                    nxt.append(v)
                if depth[v] == depth[u] + 1:
                    sigma[v] += sigma[u]
        levels.append(nxt)
    levels.pop()
    # backward accumulation
    delta = np.zeros(m, np.float64)
    # farthest to closest, INCLUDING the source level (verifier.cc:111-124)
    for lvl in reversed(levels):
        for u in lvl:
            for v in _neigh(g, u):
                if depth[v] == depth[u] + 1:
                    delta[u] += sigma[u] / sigma[v] * (1.0 + delta[v])
        for u in lvl:
            scores[u] = delta[u]
    mx = scores.max()
    if mx > 0:
        scores = scores / mx
    return scores.astype(np.float32)


def tc_serial(g_dag) -> int:
    """Triangle count over a DAG-oriented graph: sum of |N(u) ∩ N(v)| per
    edge (src/tc/omp_base.cc:16-21)."""
    total = 0
    rp, ci = g_dag.rowptr, g_dag.colidx
    neigh = [set(ci[rp[v]:rp[v + 1]].tolist()) for v in range(g_dag.m)]
    for u in range(g_dag.m):
        for v in ci[rp[u]:rp[u + 1]]:
            total += len(neigh[u] & neigh[int(v)])
    return total


def vc_check(g, colors: np.ndarray) -> bool:
    """Proper-coloring predicate (src/vc/verifier.cc)."""
    src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    return bool(np.all(colors[src] != colors[g.colidx]))


def symgs_serial(g, indices, Ax, diag, x, b, color_offsets) -> np.ndarray:
    """Serial multi-color symmetric Gauss-Seidel sweep
    (src/symgs/omp_base.cc:7-41): forward over color blocks then backward."""
    x = np.asarray(x, np.float64).copy()
    Ax = np.asarray(Ax, np.float64)
    b = np.asarray(b, np.float64)
    rp, ci = g.rowptr, g.colidx
    order = list(range(len(color_offsets) - 1))
    for blocks in (order, order[::-1]):
        for blk in blocks:
            for i in indices[color_offsets[blk]:color_offsets[blk + 1]]:
                row_sum = 0.0
                for e in range(rp[i], rp[i + 1]):
                    row_sum += x[ci[e]] * Ax[e]
                x[i] = (b[i] - row_sum) / diag[i] if diag[i] != 0 else x[i]
    return x.astype(np.float32)


def scc_serial(g) -> np.ndarray:
    """Iterative Tarjan SCC (the reference verifier's oracle,
    src/scc/verifier.cc:44 tarjan_scc).  Returns component labels
    (first-visited member's preorder id — compare up to renaming)."""
    m = g.m
    rp, ci = g.rowptr, g.colidx
    index = np.full(m, -1, np.int64)
    lowlink = np.zeros(m, np.int64)
    on_stack = np.zeros(m, bool)
    labels = np.full(m, -1, T.COMP_DTYPE)
    counter = 0
    n_scc = 0
    stack = []
    for s in range(m):
        if index[s] >= 0:
            continue
        work = [(s, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = lowlink[v] = counter
                counter += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            for j in range(rp[v] + pi, rp[v + 1]):
                w = ci[j]
                if index[w] < 0:
                    work[-1] = (v, j - rp[v] + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                elif on_stack[w]:
                    lowlink[v] = min(lowlink[v], index[w])
            if recurse:
                continue
            if lowlink[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    labels[w] = n_scc
                    if w == v:
                        break
                n_scc += 1
            work.pop()
            if work:
                u = work[-1][0]
                lowlink[u] = min(lowlink[u], lowlink[v])
    return labels


def mst_total_weight(g) -> float:
    """Kruskal oracle for the MST/MSF total weight (the reference has no
    separate verifier — src/mst/main.cu prints mstwt directly)."""
    s = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    d = np.asarray(g.colidx)
    w = np.asarray(g.weights if g.weights is not None else np.ones(g.nnz))
    order = np.argsort(w, kind="stable")
    parent = list(range(g.m))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    total = 0.0
    for e in order:
        ru, rv = find(int(s[e])), find(int(d[e]))
        if ru != rv:
            parent[ru] = rv
            total += float(w[e])
    return total


def sgd_rmse(row_offsets, colidx, ratings, user_lv, item_lv) -> float:
    """RMSE of a rating-matrix factorization (src/sgd/omp_base.cc:89-99)."""
    m = len(row_offsets) - 1
    src = np.repeat(np.arange(m), np.diff(row_offsets))
    pred = np.einsum("ek,ek->e", user_lv[src], item_lv[colidx])
    err = np.asarray(ratings, np.float64) - pred
    return float(np.sqrt((err ** 2).sum() / len(ratings))) if len(ratings) \
        else 0.0
