"""Frontier primitives — dense masks, compaction and edge expansion; torch
counterpart of gardenia_tpu/ops/frontier.py.

A frontier is a dense mask; `compact_mask` turns it into a padded id list
of fixed size and `expand_frontier_edges` flattens the out-edges of such
a list (the reference's load-balanced gather, src/bfs/linear_lb.cu:24-182)
by a cumsum, a scatter-max of each row's index at its start offset and a
running max.  Nothing here reads back to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch

from gardenia_tpu_torch.ops.semiring import drop_index


def compact_mask(mask: torch.Tensor, size: int, fill: int) -> torch.Tensor:
    """i32[size]: the indices where mask is true, in order, truncated to
    `size` and padded with `fill` — jnp.nonzero(mask, size=, fill_value=)."""
    pos = torch.cumsum(mask, 0) - 1
    keep = mask & (pos < size)
    out = torch.full((size + 1,), fill, dtype=torch.int32, device=mask.device)
    # entries not kept all land on the pad slot `size`, sliced off below
    out[torch.where(keep, pos, size)] = torch.arange(
        mask.shape[0], dtype=torch.int32, device=mask.device)
    return out[:size]


def frontier_degree_sum(mask: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """Total out-edges leaving the frontier (scout_count,
    src/bfs/omp_beamer.cc:40-49)."""
    return torch.where(mask, deg, 0).sum()


def expand_frontier_edges(rowptr: torch.Tensor,
                          colidx: torch.Tensor,
                          frontier_ids: torch.Tensor,
                          capacity: int
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """Flatten the out-edges of `frontier_ids` into padded arrays.

    frontier_ids: i32[P], padded with m (a row with no edges: rowptr has
    m + 1 entries).  Returns (src i32[capacity], dst i32[capacity], valid
    bool[capacity], eid i64[capacity] — the CSR edge slot).  Slots at or
    past the total edge count are invalid; their src may be the pad id m.
    """
    nnz = colidx.shape[0]
    dev = frontier_ids.device
    fid = frontier_ids.long()
    starts = rowptr[fid]
    ends = rowptr[torch.clamp(fid + 1, max=rowptr.shape[0] - 1)]
    lens = torch.clamp(ends - starts, min=0)
    cum_ends = torch.cumsum(lens, 0)
    offsets = cum_ends - lens
    total = cum_ends[-1] if lens.shape[0] else torch.zeros((), device=dev)
    # owner f of edge slot j: each row's index scattered (max) at its start
    # offset, then a running max; rows of length 0 share an offset with
    # their successor and the max keeps the first non-empty owner
    p = torch.arange(fid.shape[0], dtype=torch.int64, device=dev)
    marks = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    marks.scatter_reduce_(0, drop_index(offsets, capacity), p, "amax")
    f = torch.cummax(marks[:capacity], 0).values
    slot = torch.arange(capacity, dtype=torch.int64, device=dev)
    e = starts[f] + (slot - offsets[f])
    valid = slot < total
    e = torch.clamp(e, 0, max(nnz - 1, 0))
    dst = colidx[e] if nnz else torch.zeros(capacity, dtype=torch.int32,
                                            device=dev)
    return frontier_ids[f], dst, valid, e
