"""Generalized SpMV over the ELL slab layout (torch counterpart of
gardenia_tpu/ops/spmv.py::spmv_ell).

Plain torch: per slab, gather x along the (W, R) column tile with a pad
slot at index n, combine with the semiring, reduce across W, and scatter
the partials into y, which carries a pad row for the row sentinel.  In
JAX this is XLA, not Pallas; a hand-written CUDA kernel for it is a later
item (ROADMAP).  The TPU-only row-select gather (ops/rowsel.py) is not
ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from gardenia_tpu_torch.ops.ell import EllMatrix
from gardenia_tpu_torch.ops.semiring import (F32_PLUS_TIMES, Semiring,
                                             drop_index)


def spmv_ell(ell: EllMatrix,
             x: torch.Tensor,
             *,
             semiring: Semiring = F32_PLUS_TIMES,
             num_rows: int,
             init: Optional[torch.Tensor] = None,
             row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y[i] = add_j mul(A[i,j], x[j]), combined into `init` (default: zero).

    row_mask (bool[num_rows], optional): rows where mask is False keep their
    init value.  Row ids outside [0, num_rows) are dropped, as in JAX.
    """
    dt = semiring.dtype
    x_ext = torch.cat([x.to(dt), x.new_full((1,), semiring.pad_x, dtype=dt)])
    # y carries one pad row (index num_rows) that absorbs sentinel rows;
    # it is updated in place bucket by bucket and sliced off at the end
    y = x.new_full((num_rows + 1,), semiring.zero, dtype=dt)
    if init is not None:
        y[:num_rows] = init.to(dt)
    zero = torch.tensor(semiring.zero, dtype=dt, device=x.device)
    for b in ell.buckets:
        gathered = x_ext[b.cols]                       # (W, R)
        if b.vals is not None:
            prod = semiring.mul(b.vals.to(dt), gathered)
        else:
            prod = gathered
        partial = semiring.reduce(prod, 0)             # (R,)
        rows = drop_index(b.row_ids, num_rows)
        if row_mask is not None:
            keep = row_mask[rows.clamp(max=num_rows - 1)]
            partial = torch.where(keep, partial, zero)
        semiring.scatter_(y, rows, partial)
    return y[:num_rows]
