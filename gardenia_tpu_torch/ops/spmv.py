"""Generalized SpMV (torch counterpart of gardenia_tpu/ops/spmv.py):
`spmv_ell` over the ELL slab layout, `spmv_segment` over COO edges (the
push direction), `spmv_batched` for S operand vectors at once, and
`make_push_pb`, the propagation-blocking push (the transpose product).

Plain torch: per slab, gather x along the (W, R) column tile with a pad
slot at index n, combine with the semiring, reduce across W, and scatter
the partials into y, which carries a pad row for the row sentinel.  In
JAX this is XLA, not Pallas; a hand-written CUDA kernel for it is a later
item (ROADMAP).  The TPU-only row-select gather (ops/rowsel.py) is not
ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
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


def row_offsets(row_ids_sorted: torch.Tensor, num_rows: int) -> torch.Tensor:
    """i64[num_rows + 1] CSR offsets of a non-decreasing row-id list."""
    ids = torch.arange(num_rows + 1, dtype=row_ids_sorted.dtype,
                       device=row_ids_sorted.device)
    return torch.searchsorted(row_ids_sorted, ids)


def spmv_batched(row_ids_sorted: torch.Tensor, col_ids: torch.Tensor,
                 x2d: torch.Tensor, *, num_rows: int,
                 offsets: Optional[torch.Tensor] = None,
                 vals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-vector plus-times SpMV: y[i, :] = sum_j A[i,j] x2d[j, :], f32.

    x2d: (n, S) operand, S problems in the last dimension; the per-edge
    gather fetches whole S-rows.  row_ids_sorted: i32[nnz] destination row
    per edge, non-decreasing (CSR order); col_ids: i32[nnz] operand row;
    offsets: row_offsets(row_ids_sorted, num_rows) where the caller keeps
    them; vals: f32[nnz] edge weights, all ones where absent.

    The rows are sorted, so the segment sum is `torch.segment_reduce`
    over the CSR offsets: no atomics, the same sum in every run.  On an
    NVIDIA H100 at R-MAT-20 and S = 128 it took 6.5 ms where `index_add_`
    took 11.4 (7.4M gathered rows of 512 bytes; chip_smoke.py times both).
    """
    if offsets is None:
        offsets = row_offsets(row_ids_sorted, num_rows)
    gathered = x2d.float()[col_ids]
    if vals is not None:
        gathered = gathered * vals[:, None]
    return torch.segment_reduce(gathered, "sum", offsets=offsets, axis=0)


def spmv_segment(row_ids: torch.Tensor, col_ids: torch.Tensor,
                 vals: Optional[torch.Tensor], x: torch.Tensor, *,
                 semiring: Semiring = F32_PLUS_TIMES, num_rows: int,
                 init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """COO-form generalized SpMV: scatter-combine per edge.  Also the
    push-direction primitive (reference push variants, e.g.
    src/pr/push.cu): call with (row_ids=dst, col_ids=src).  Column ids
    outside [0, len(x)) read the semiring's pad value and row ids outside
    [0, num_rows) are dropped, as in JAX."""
    dt = semiring.dtype
    x_ext = torch.cat([x.to(dt), x.new_full((1,), semiring.pad_x, dtype=dt)])
    gathered = x_ext[drop_index(col_ids, x.shape[0])]
    prod = gathered if vals is None else semiring.mul(vals.to(dt), gathered)
    if init is None:
        y = x.new_full((num_rows,), semiring.zero, dtype=dt)
    else:
        y = init.to(dt)
    return semiring.scatter_into(y, row_ids, prod)


def make_push_pb(g, weights=None, *, device):
    """Propagation-blocking push SpMV (reference include/prop_blocking.h,
    src/pr/pb.cc; gardenia_tpu/ops/spmv.py:105-143): fn(x) -> y with
    y[i] = sum_j A[j, i] x[j], the transpose product, f32[g.n].

    Where each source-ordered edge product lands in destination order is
    a static permutation, argsort(dst, kind="stable"), computed once on
    the host; the accumulation is a sorted segment sum over the
    destination offsets (spmv_batched with one column).  Applying the
    permutation to the gather indices and the weights once, at set-up,
    gives the products in the order that binning them would.  weights:
    edge values in forward-CSR order, or None (ones)."""
    from gardenia_tpu_torch.core import build

    src, dst = build.csr_to_coo(g.rowptr, g.colidx)
    order = np.argsort(dst, kind="stable")
    dst_sorted = torch.from_numpy(dst[order].astype(np.int32)).to(device)
    src_binned = torch.from_numpy(src[order].astype(np.int32)).to(device)
    vals = None if weights is None else torch.from_numpy(
        np.asarray(weights, np.float32)[order]).to(device)
    offsets = row_offsets(dst_sorted, g.n)

    def push(x: torch.Tensor) -> torch.Tensor:
        return spmv_batched(dst_sorted, src_binned, x.float()[:, None],
                            num_rows=g.n, offsets=offsets, vals=vals)[:, 0]

    return push
