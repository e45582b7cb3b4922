"""Sorted-adjacency membership counts — torch counterpart of
gardenia_tpu/ops/intersect.py (an XLA formulation there, plain torch
here).

Given per-query (element w, target row v), count how many w appear in the
sorted neighbour list N(v): a batch of queries runs `search_rounds`
rounds of one gather and one compare each (a vectorised lower_bound).
The reference's one-hot row select (`rowsel.take`/`gather`) is a TPU
gather workaround; here it is plain indexing.
"""

from __future__ import annotations

import torch


def membership_counts(rowptr: torch.Tensor, colidx: torch.Tensor,
                      queries: torch.Tensor, rows: torch.Tensor,
                      search_rounds: int = 32) -> torch.Tensor:
    """int64 scalar tensor: sum over i of [queries[i] in N(rows[i])].

    rowptr int[m+1], colidx int[nnz] with SORTED neighbour lists;
    queries and rows are equal-length 1-D tensors.
    """
    nnz = colidx.shape[0]
    if nnz == 0:
        return torch.zeros((), dtype=torch.int64, device=colidx.device)
    lo = rowptr[rows].long()
    end = rowptr[rows + 1].long()
    hi = end.clone()
    for _ in range(search_rounds):
        # lower_bound: invariant colidx[lo-1] < q <= colidx[hi]
        active = lo < hi
        mid = (lo + hi) // 2
        go_right = colidx[mid.clamp(0, nnz - 1)] < queries
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    found = (lo < end) & (colidx[lo.clamp(0, nnz - 1)] == queries)
    return torch.sum(found, dtype=torch.int64)
