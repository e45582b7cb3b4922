"""kCL — k-clique counting on the degree-ordered DAG; torch counterpart of
gardenia_tpu/mining/kcl.py (reference mining/kcl_dfs/{kcl.h,omp_base.cc},
include/cmap.h).

Key invariant (kcl.h:17-21): in the DAG every k-clique has exactly one
topological order v1 -> v2 -> ... -> vk, and all later members lie in
N+(v1).  So each clique is counted once, by its first vertex v1.

Two routes give the same per-vertex counts cnt[v1] (int64):
  "q1"     kernel Q1 (ops/kcl_count, csrc/kcl_local_count.cu): each
           vertex's out-neighbourhood becomes a bitmap graph in shared
           memory and cliques are counted by ANDs and popcounts — the
           design of the reference's GPU kcl_dfs.  On CPU tensors its
           wrapper takes the plain version, `expand_counts`.
  "expand" `expand_counts`, the level expansion of the JAX package
           (kcl.py:448-546, 858-922) in plain torch: a level-l embedding
           (v1..vl) extends with x in N+(v1) such that x in N+(vi) for
           i >= 2; per level a count pass, then a fill pass that compacts
           the survivors; the last level only counts.  It takes what Q1
           does not: k above Q1's cap or an out-degree above its limit.
The route is chosen from the graph's shape before any launch
(`kcl_count.route`), never by retrying after a failure; `LAST_ROUTE`
names what the last `kcl_solver` call ran: "q1", "expand", "tc" for
k = 3, or "q1_plain" where Q1's shape met a DAG on the CPU, whose
wrapper took its plain version.

The JAX package's TPU machinery (lane rotations, the class sort and its
windows, the candidate-mask engine, the int32 guards, the rowsel gathers,
the loops that split work under the remote worker's program kill, the
GDN_KCL_TIME trace) does not come across.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core.views import _key

# the port's memory budget for one slice of the level expansion, in
# wedges: its count pass holds a bool a wedge, its fill pass an int64
# index and up to 8 int32 ids a survivor (about 5.5 GB at 2^27 if every
# wedge survived).  Indices are int64, so no int32 limit applies.
# mining/gspan imports the name.
EMB_WEDGE_LIMIT = 1 << 27

LAST_ROUTE = None


def wedge_slices(counts: np.ndarray, limit: int) -> List[tuple]:
    """Split range(len(counts)) into [lo, hi) slices whose count sums
    stay <= limit (greedy; one count alone never exceeds it because
    counts are vertex degrees < 2^31)."""
    n = len(counts)
    if n == 0:
        return []
    cum = np.cumsum(counts, dtype=np.int64)
    out = []
    lo = 0
    while lo < n:
        base = cum[lo - 1] if lo else 0
        hi = int(np.searchsorted(cum, base + limit, side="right"))
        hi = max(hi, lo + 1)
        out.append((lo, hi))
        lo = hi
    return out


def search_rounds(max_degree: int) -> int:
    """Rounds of `_member`'s binary search that settle a row of
    max_degree ids."""
    return max(1, int(max_degree).bit_length()) + 1


def _member(rowptr, colidx, nnz, queries, rows, rounds: int = 32):
    """bool: queries[i] in N(rows[i]), a vectorised binary search over the
    sorted rows of the CSR (kcl.py:549-569); `rounds` must settle the
    longest row (`search_rounds`)."""
    if nnz == 0:
        return torch.zeros(queries.shape, dtype=torch.bool,
                           device=queries.device)
    rows = rows.long()
    lo = rowptr[rows].long()
    end = rowptr[rows + 1].long()
    hi = end.clone()
    for _ in range(rounds):
        active = lo < hi
        mid = (lo + hi) // 2
        right = colidx[mid.clamp(0, nnz - 1)] < queries
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return (lo < end) & (colidx[lo.clamp(0, nnz - 1)] == queries)


def expand_counts(rowptr: torch.Tensor, colidx: torch.Tensor, k: int, *,
                  chunk: int = 1 << 23) -> torch.Tensor:
    """int64[m]: the k-cliques of the DAG (rowptr int64[m+1], colidx
    int32 with sorted rows) whose first vertex is v, by the level
    expansion; `chunk` wedges a step.  A candidate's membership tests
    are one `torch.searchsorted` each over the arcs' keys v * m + x."""
    m = rowptr.numel() - 1
    dev = colidx.device
    cnt = torch.zeros(m, dtype=torch.int64, device=dev)
    nnz = colidx.numel()
    if nnz == 0:
        return cnt
    chunk = max(1, int(chunk))
    deg = rowptr[1:] - rowptr[:-1]
    deg_h = deg.cpu().numpy()
    col = colidx.long()
    # arc (v, x) as the key v * m + x: ascending, as rows come in order
    # and each row is sorted
    keys = torch.repeat_interleave(
        torch.arange(m, dtype=torch.int64, device=dev), deg) * m + col

    def has_arc(v, x):
        q = v.long() * m + x
        return keys[torch.searchsorted(keys, q).clamp_(max=nnz - 1)] == q

    def window(members, piv, wpe, cum, s, e):
        """(embedding, whether its candidate survives) of wedge slots
        [s, e)."""
        j = torch.arange(s, e, dtype=torch.int64, device=dev)
        emb = torch.searchsorted(cum, j, right=True)
        p = piv[emb]
        row = members[p, emb].long()
        x = col[rowptr[row] + j - (cum[emb] - wpe[emb])]
        ok = torch.ones(e - s, dtype=torch.bool, device=dev)
        for i in range(members.shape[0] - 1):
            other = members[i + (i >= p).long(), emb]
            ok &= has_arc(other, x)
        return emb, ok

    def expand(members, level):
        """Extend the level-l embeddings `members` (l, N) int32: the
        candidates of each are the out-neighbours of its member of least
        out-degree (`piv`), each tested against the other members."""
        wpe_all, piv_all = deg[members.long()].min(0)
        for lo, hi in wedge_slices(wpe_all.cpu().numpy(), EMB_WEDGE_LIMIT):
            sub, wpe, piv = members[:, lo:hi], wpe_all[lo:hi], piv_all[lo:hi]
            cum = torch.cumsum(wpe, 0)
            total = int(cum[-1])
            steps = [(s, min(total, s + chunk))
                     for s in range(0, total, chunk)]
            if level == k - 1:                       # the last level counts
                for s, e in steps:
                    emb, ok = window(sub, piv, wpe, cum, s, e)
                    cnt.index_add_(0, sub[0, emb].long(), ok.long())
                continue
            ok_all = torch.empty(total, dtype=torch.bool, device=dev)
            for s, e in steps:                       # count pass
                ok_all[s:e] = window(sub, piv, wpe, cum, s, e)[1]
            keep = torch.nonzero(ok_all).flatten()
            if keep.numel() == 0:
                continue
            nxt = torch.empty((level + 1, keep.numel()), dtype=torch.int32,
                              device=dev)
            for s in range(0, keep.numel(), chunk):  # fill pass
                j = keep[s:s + chunk]
                emb = torch.searchsorted(cum, j, right=True)
                row = sub[piv[emb], emb].long()
                nxt[:level, s:s + chunk] = sub[:, emb]
                nxt[level, s:s + chunk] = colidx[rowptr[row] + j
                                                 - (cum[emb] - wpe[emb])]
            del ok_all, keep
            expand(nxt, level + 1)

    # level-2 embeddings are the DAG's arcs; arc e seeds deg+(src) wedges
    src_h = np.repeat(np.arange(m, dtype=np.int64), deg_h)
    src = torch.from_numpy(src_h.astype(np.int32)).to(dev)
    for lo, hi in wedge_slices(deg_h[src_h], EMB_WEDGE_LIMIT):
        expand(torch.stack([src[lo:hi], colidx[lo:hi]]), 2)
    return cnt


def local_dag(g, device):
    """g's degree-order DAG (`g.oriented()`) on `device`, prepared for Q1
    (ops/kcl_count.prepare), cached on g."""
    from gardenia_tpu_torch.ops import kcl_count
    dag = g._dev(("oriented",), g.oriented)
    return dag._dev(_key("kcl_dag", device), lambda: kcl_count.prepare(
        torch.from_numpy(dag.rowptr.astype(np.int64)).to(device),
        torch.from_numpy(np.ascontiguousarray(dag.colidx)).to(device)))


def kcl_solver(g, k: int, *, force_expand: bool = False,
               device="cuda") -> int:
    """Reference entry KCLSolver(g, k, total, nthreads) (mining/kcl_dfs/
    kcl.h:28).  g: undirected (symmetric) graph; the degree-order DAG
    (`g.oriented()`: degree, then id) is applied internally.

    k = 3 goes to tc_solver unless force_expand is set (kcl.py:802-806);
    with it, k = 3 counts through Q1 or the expansion like any k — the
    CLI's at-scale cross-check of the triangle count."""
    global LAST_ROUTE
    if k < 3:
        raise ValueError(f"kcl_solver needs k >= 3, got {k}")
    dev = resolve_device(device)
    if k == 3 and not force_expand:
        from gardenia_tpu_torch.solvers.tc import tc_solver
        LAST_ROUTE = "tc"
        return tc_solver(g, device=dev)
    from gardenia_tpu_torch.ops import kcl_count
    ldag = local_dag(g, dev)
    route = kcl_count.route(ldag.max_degree, k)
    if route == "q1":
        cnt = kcl_count.local_count(ldag, k)
        if ldag.colidx.device.type == "cpu":
            route = "q1_plain"          # the wrapper took its plain version
    else:
        cnt = expand_counts(ldag.rowptr, ldag.colidx, k)
    LAST_ROUTE = route
    return int(cnt.sum())


def kcl_verifier(g, k: int) -> int:
    """Serial oracle: DFS clique extension over the DAG (the reference
    verifier re-runs the solver serially, mining/kcl_dfs/verifier.cc)."""
    dag = g.oriented()
    rp, ci = dag.rowptr, dag.colidx
    neigh = [set(ci[rp[v]:rp[v + 1]].tolist()) for v in range(dag.m)]

    def extend(members, cands, depth):
        if depth == k:
            return len(cands)
        total = 0
        for x in cands:
            total += extend(members + [x], cands & neigh[x], depth + 1)
        return total

    total = 0
    for v in range(dag.m):
        total += extend([v], neigh[v], 2)
    return total
