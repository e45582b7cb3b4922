"""Hybrid block-sparse SpMV — torch counterpart of gardenia_tpu/ops/bsr.py.

Edges are grouped by (dst_block, src_block) pairs of 128 vertices; pairs
with >= `dense_threshold` edges become 128x128 dense blocks (int8 edge
counts when unweighted, bf16 for integral weights up to 256, f32
otherwise), stored as ROW PANELS bucketed by blocks per destination row;
the sparser pairs form an ELL remainder (ops/ell.py).  See the reference
module for the layout's design.

`build_hybrid` is a numpy-only copy of the reference builder, with the
same constants, so that the layout is identical and tests can assert
equality.  One deliberate difference: the reference falls back to f32
panels whenever `ml_dtypes` cannot be imported (it has no numpy bf16
without it), which on a machine without jax would quadruple the int8
panel stream.  This copy never imports ml_dtypes: int8 stays int8, and a
bf16 panel is built in f32 and converted through torch.

`spmv_hybrid` runs each panel array through kernel K1 (ops/panel.py) with
an f32 operand and f32 accumulation, and the remainder through spmv_ell.
`spmv_hybrid_batched` does the same for S operand vectors at once: K1's
tensor-core kernel on the panels (an f32 operand split into its three
bf16 terms once an apply), a per-edge row gather and a segment sum on the
remainder.  The reference's hi/lo bf16 operand split, its `exact=`
and `use_pallas=` arguments and its `_small_dense` precision policy were
MXU workarounds and are not ported: the operand's dtype states the
precision (f32: f32-faithful products; bf16: one bf16 pass).
`spmv_hybrid_min_select` (CC's label sweep) runs each panel array through
kernel K2 (ops/minselect.py) and the remainder through spmv_ell's
min-select; `spmv_hybrid_min_plus` (SSSP's relaxation over the weighted
layout) runs them through kernel M1, K2's min-plus twin, and the
remainder through spmv_ell's min-plus.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gardenia_tpu_torch.ops import minselect as _minselect
from gardenia_tpu_torch.ops import panel as _panel
from gardenia_tpu_torch.ops.ell import EllMatrix, build_ell, from_jax_ell

LANES = 128
LANE_BITS = 7

MAX_PANEL_WIDTH = 32     # blocks per row slot; wider rows split slots

# blocks per panel array (kept from the reference so that the layouts are
# identical; on Hopper it only bounds the size of one K1 launch)
MAX_PANEL_BLOCKS = 49152


@dataclasses.dataclass
class DensePanel:
    """One width bucket of the dense layout: panel[r, i, w*128 + j] holds
    A[rows[r]*128 + i, src[r, w]*128 + j] (zero-padded slots)."""
    panel: torch.Tensor    # int8|bf16|f32 [R, 128, width*128]
    src: torch.Tensor      # i32[R, width] operand block column
    rows: torch.Tensor     # i32[R] destination block row (may repeat)
    width: int

    def to(self, device) -> "DensePanel":
        return DensePanel(self.panel.to(device), self.src.to(device),
                          self.rows.to(device), self.width)


@dataclasses.dataclass
class HybridMatrix:
    """Dense row panels plus an ELL + dst-sorted-COO remainder.

    scale: constant-value factorization — a matrix whose weights all equal
    w0 stores the unweighted count layout and consumers multiply y by
    `scale` once."""
    dense: Tuple[DensePanel, ...]
    rem: EllMatrix
    rem_dst: torch.Tensor            # i32[R] remainder dst, non-decreasing
    rem_src: torch.Tensor            # i32[R] remainder src
    rem_w: Optional[torch.Tensor]    # f32[R] weights, or None (unweighted)
    scale: float = 1.0
    # i64[rows + 1] CSR offsets of rem_dst, made at the first batched apply
    rem_offsets: Optional[torch.Tensor] = None

    def to(self, device) -> "HybridMatrix":
        return HybridMatrix(
            tuple(p.to(device) for p in self.dense), self.rem.to(device),
            self.rem_dst.to(device), self.rem_src.to(device),
            None if self.rem_w is None else self.rem_w.to(device),
            self.scale)

    @property
    def num_blocks(self) -> int:
        return sum(p.panel.shape[0] * p.width for p in self.dense)


def _pow2ceil(x: np.ndarray) -> np.ndarray:
    out = np.ones_like(x)
    while True:
        need = out < x
        if not need.any():
            return out
        out[need] *= 2


def build_hybrid(rowptr: np.ndarray,
                 colidx: np.ndarray,
                 weights: Optional[np.ndarray] = None,
                 *,
                 num_cols: int,
                 dense_threshold: int = 16,
                 factor_scale: bool = True) -> HybridMatrix:
    """Host-side grouping of a CSR matrix into the hybrid layout (CPU
    tensors; `.to(device)` uploads).

    weights None -> unweighted int8 edge counts; weighted panels take the
    narrowest of int8, bf16 and f32 that holds their cells exactly, as the
    reference's block_dtype='auto' does (its block_dtype option has no
    caller in the port and is not carried).  factor_scale=False keeps
    uniform weights in the panels (parallel/partition's stacked form needs
    one scale across shards).  Duplicate edges accumulate additively in
    both layouts.
    """
    from gardenia_tpu_torch.core import build as _build

    num_rows = len(rowptr) - 1
    nnz = len(colidx)
    rowptr = np.asarray(rowptr, np.int64)
    dst = np.repeat(np.arange(num_rows, dtype=np.int64), np.diff(rowptr))
    src = np.asarray(colidx, np.int64)
    # constant-value factorization: A = w0 * structure rides the
    # unweighted int8 count layout and consumers scale y once
    scale = 1.0
    if factor_scale and weights is not None and nnz:
        w0 = np.asarray(weights).flat[0]
        if w0 != 0 and np.all(weights == w0):
            scale = float(w0)
            weights = None
    w = np.ones(nnz, np.float32) if weights is None else \
        np.asarray(weights, np.float32)
    db, dr = dst >> LANE_BITS, (dst & (LANES - 1)).astype(np.int32)
    sb, sr = src >> LANE_BITS, (src & (LANES - 1)).astype(np.int32)
    sb_span = (num_cols >> LANE_BITS) + 2
    key = db * sb_span + sb
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, cnt = np.unique(key_s, return_counts=True)
    dense_sel = cnt >= dense_threshold
    # always try int8: the value guard below demotes panels whose
    # accumulated cells do not fit
    blk_dtype = "int8"

    # ---- dense panels ------------------------------------------------------
    nB = int(dense_sel.sum())
    gid = np.searchsorted(uniq, key_s)               # group of each edge
    edge_dense = dense_sel[gid]
    if nB:
        dkeys = uniq[dense_sel]
        blk_dst = (dkeys // sb_span).astype(np.int64)  # non-decreasing
        blk_src = (dkeys % sb_span).astype(np.int32)

        # slot assignment: blocks of one dst row are consecutive; rows
        # wider than MAX_PANEL_WIDTH split into multiple slots
        row_change = np.empty(nB, bool)
        row_change[0] = True
        np.not_equal(blk_dst[1:], blk_dst[:-1], out=row_change[1:])
        row_start_idx = np.flatnonzero(row_change)
        row_of_block = np.cumsum(row_change) - 1
        w_global = np.arange(nB, dtype=np.int64) \
            - row_start_idx[row_of_block]
        slot_change = row_change | (w_global % MAX_PANEL_WIDTH == 0)
        slot_of_block = np.cumsum(slot_change) - 1     # global slot id
        w_in_slot = (w_global % MAX_PANEL_WIDTH).astype(np.int64)
        slot_starts = np.flatnonzero(slot_change)
        slot_cnt = np.diff(np.r_[slot_starts, nB])
        slot_row = blk_dst[slot_starts].astype(np.int32)
        slot_width = _pow2ceil(slot_cnt.astype(np.int64))

        # dedup cells once, keyed (block, dr, sr)
        bofe = np.searchsorted(dkeys, key_s[edge_dense])
        eo = order[edge_dense]
        cells = LANES * LANES
        gidx = bofe * cells + (dr[eo].astype(np.int64) * LANES + sr[eo])
        o3 = np.argsort(gidx, kind="stable")
        gi = gidx[o3]
        boundary = np.empty(len(gi), bool)
        boundary[0] = True
        np.not_equal(gi[1:], gi[:-1], out=boundary[1:])
        starts = np.flatnonzero(boundary)
        if weights is None and len(starts) == len(gi):
            vals = np.ones(len(starts), np.float32)   # all cells unique
        else:
            vals = np.add.reduceat(w[eo][o3], starts)
        if (vals.max(initial=0) > 127 or vals.min(initial=0) < -128
                or (vals != np.round(vals)).any()):
            if (vals == np.round(vals)).all() and \
                    np.abs(vals).max(initial=0) <= 256:
                # integers up to 256 are exact in bfloat16 (2 B/entry)
                blk_dtype = "bfloat16"
            else:
                # counts > 256 / fractional values must stay exact
                blk_dtype = "float32"
        # numpy has no bfloat16: bf16 panels are filled in f32 and
        # converted by torch (exact for the integers that choose bf16)
        np_dtype = np.int8 if blk_dtype == "int8" else np.float32
        cell_b = (gi[starts] // cells).astype(np.int64)
        cell_loc = gi[starts] % cells                  # dr*128 + sr
        cell_dr = cell_loc // LANES
        cell_sr = cell_loc % LANES

        panels = []
        n_slots_total = len(slot_cnt)
        slot_pos = np.full(n_slots_total, -1, np.int64)
        for width in np.unique(slot_width):
            idxs = np.flatnonzero(slot_width == width)
            spp = max(1, MAX_PANEL_BLOCKS // int(width))
            for g0 in range(0, len(idxs), spp):
                sub = idxs[g0:g0 + spp]
                n_slots = len(sub)
                slot_pos[:] = -1
                slot_pos[sub] = np.arange(n_slots)
                bpos = slot_pos[slot_of_block]
                bsel = bpos >= 0
                src_tbl = np.zeros((n_slots, width), np.int32)
                src_tbl[bpos[bsel], w_in_slot[bsel]] = blk_src[bsel]
                rows_tbl = slot_row[sub]
                panel = np.zeros((n_slots, LANES, width * LANES), np_dtype)
                csel = bsel[cell_b]
                cb = cell_b[csel]
                flat = (bpos[cb] * LANES + cell_dr[csel]) \
                    * (width * LANES) \
                    + w_in_slot[cb] * LANES + cell_sr[csel]
                panel.reshape(-1)[flat] = vals[csel].astype(np_dtype)
                tpanel = torch.from_numpy(panel)
                if blk_dtype == "bfloat16":
                    tpanel = tpanel.to(torch.bfloat16)
                panels.append(DensePanel(tpanel, torch.from_numpy(src_tbl),
                                         torch.from_numpy(rows_tbl),
                                         int(width)))
        dense = tuple(panels)
    else:
        dense = ()

    # ---- ELL remainder -----------------------------------------------------
    eo = order[~edge_dense]
    rs, rd, rw = src[eo], dst[eo], w[eo]
    ro = np.lexsort((rs, rd))
    rs, rd, rw = rs[ro].astype(np.int32), rd[ro].astype(np.int32), rw[ro]
    rem_rp, rem_ci, rem_wc = _build.coo_to_csr(
        num_rows, rd, rs, rw if weights is not None else None,
        sorted_by_src=True)
    rem = build_ell(rem_rp, rem_ci, rem_wc, num_cols=num_cols)
    return HybridMatrix(dense, rem, torch.from_numpy(rd),
                        torch.from_numpy(rs),
                        torch.from_numpy(rw) if weights is not None else None,
                        scale)


def _tensor(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes: same bits as torch's
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def from_jax_hybrid(hyb) -> HybridMatrix:
    """Carry a gardenia_tpu HybridMatrix (JAX or numpy arrays) across as
    CPU tensors, through numpy."""
    dense = tuple(DensePanel(_tensor(p.panel), _tensor(p.src),
                             _tensor(p.rows), p.width) for p in hyb.dense)
    return HybridMatrix(dense, from_jax_ell(hyb.rem), _tensor(hyb.rem_dst),
                        _tensor(hyb.rem_src),
                        None if hyb.rem_w is None else _tensor(hyb.rem_w),
                        hyb.scale)


def spmv_hybrid(hyb: HybridMatrix, x: torch.Tensor, *, num_rows: int,
                init: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = A x (plus-times, f32) over the hybrid layout, one operand
    vector (S=1).  Equal to spmv_ell(..., F32_PLUS_TIMES) on the same
    matrix up to f32 summation order."""
    from gardenia_tpu_torch.ops.semiring import F32_PLUS_TIMES
    from gardenia_tpu_torch.ops.spmv import spmv_ell

    num_cols = int(x.shape[0])
    qx = (num_cols + LANES - 1) // LANES
    mb = (num_rows + LANES - 1) // LANES
    if hyb.dense:
        x3d = x.new_zeros(qx * LANES, dtype=torch.float32)
        x3d[:num_cols] = x
        x3d = x3d.view(qx, LANES, 1)
        y3d = x.new_zeros((mb, LANES, 1), dtype=torch.float32)
        for p in hyb.dense:
            # split rows repeat in p.rows: index_add_ sums their slots
            y3d.index_add_(0, p.rows,
                           _panel.dense_panel_matmul(p.panel, p.src, x3d, 1))
        y = y3d.view(-1)[:num_rows]
    else:
        y = x.new_zeros(num_rows, dtype=torch.float32)
    if hyb.rem.buckets:
        y = spmv_ell(hyb.rem, x, semiring=F32_PLUS_TIMES,
                     num_rows=num_rows, init=y)
    if hyb.scale != 1.0:       # constant-value factorization
        y = y * hyb.scale
    return y if init is None else y + init.float()


def spmv_hybrid_batched(hyb: HybridMatrix, x2d: torch.Tensor, *,
                        num_rows: int) -> torch.Tensor:
    """Multi-vector plus-times SpMV over the hybrid layout: y[i, s] =
    sum_j A[i, j] x2d[j, s], (num_rows, S) f32, for S problems in the last
    dimension (multi-source BFS, batched Brandes BC).

    One pass over the dense panels serves all S problems (K1 at the
    batched shape); the remainder pays a per-edge gather of whole S-rows
    through rem_src, summed by the sorted rem_dst.  x2d (n, S) is f32, or
    bf16 where one bf16 pass is enough: a 0/1 frontier mask is exact in
    it, and the operand's bytes halve.  Equal to ops/spmv.spmv_batched on
    the same matrix up to f32 summation order."""
    n, S = x2d.shape
    mb = (num_rows + LANES - 1) // LANES
    if x2d.dtype != torch.bfloat16:
        x2d = x2d.float()
    if hyb.dense:
        qx = (n + LANES - 1) // LANES
        if n == qx * LANES and x2d.is_contiguous():
            x3d = x2d.view(qx, LANES, S)             # no pad rows to add
        else:
            x3d = x2d.new_zeros((qx * LANES, S))
            x3d[:n] = x2d
            x3d = x3d.view(qx, LANES, S)
        y3d = x2d.new_zeros((mb, LANES, S), dtype=torch.float32)
        parts = _panel.dense_panel_matmul_arrays(
            [(p.panel, p.src) for p in hyb.dense], x3d, S)
        for p, part in zip(hyb.dense, parts):
            # split rows repeat in p.rows: index_add_ sums their slots
            y3d.index_add_(0, p.rows, part)
        y = y3d.view(-1, S)[:num_rows]
    else:
        y = x2d.new_zeros((num_rows, S), dtype=torch.float32)
    if hyb.rem_dst.shape[0]:
        y = y + batched_remainder(hyb, x2d, num_rows)
    if hyb.scale != 1.0:       # constant-value factorization
        y = y * hyb.scale
    return y


def batched_remainder(hyb: HybridMatrix, x2d: torch.Tensor,
                      num_rows: int) -> torch.Tensor:
    """The remainder's share of spmv_hybrid_batched, (num_rows, S) f32: a
    gather of whole S-rows through rem_src (times rem_w where present),
    summed over the sorted rem_dst as ops/spmv.spmv_batched does."""
    from gardenia_tpu_torch.ops.spmv import row_offsets, spmv_batched
    if hyb.rem_offsets is None or hyb.rem_offsets.shape[0] != num_rows + 1:
        hyb.rem_offsets = row_offsets(hyb.rem_dst, num_rows)
    return spmv_batched(hyb.rem_dst, hyb.rem_src, x2d, num_rows=num_rows,
                        offsets=hyb.rem_offsets, vals=hyb.rem_w)


def spmv_hybrid_min_select(hyb: HybridMatrix, x: torch.Tensor, *,
                           num_rows: int, sentinel: int) -> torch.Tensor:
    """y[i] = min over A[i,j] != 0 of x[j] (the min-select semiring — CC
    label propagation) over the hybrid layout; rows with no neighbours
    get `sentinel`.  Each panel array goes through K2, whose per-slot
    rows are combined by an amin scatter (split rows repeat in p.rows);
    the remainder goes through spmv_ell with I32_MIN_SELECT2."""
    from gardenia_tpu_torch.ops.semiring import I32_MIN_SELECT2
    from gardenia_tpu_torch.ops.spmv import spmv_ell

    num_cols = int(x.shape[0])
    qx = (num_cols + LANES - 1) // LANES
    mb = (num_rows + LANES - 1) // LANES
    x = x.to(torch.int32)
    # label pad slots hold the sentinel (absent columns are masked by the
    # panel anyway)
    x2d = x.new_full((qx * LANES,), sentinel)
    x2d[:num_cols] = x
    x2d = x2d.view(qx, LANES)
    y2d = x.new_full((mb, LANES), sentinel)
    for p in hyb.dense:
        part = _minselect.dense_panel_minselect(p.panel, p.src, x2d,
                                                sentinel)
        y2d.scatter_reduce_(0, p.rows.long()[:, None].expand_as(part), part,
                            "amin")
    y = y2d.view(-1)[:num_rows]
    if hyb.rem.buckets:
        y = spmv_ell(hyb.rem, x, semiring=I32_MIN_SELECT2,
                     num_rows=num_rows, init=y)
    return y


def spmv_hybrid_min_plus(hyb: HybridMatrix, x: torch.Tensor, *,
                         num_rows: int, sentinel: int) -> torch.Tensor:
    """y[i] = min over A[i,j] != 0 of (x[j] + w[i,j]), int32 (the SSSP
    relaxation, reference src/sssp/omp_base.cc:45-58) over the WEIGHTED
    hybrid layout; rows with no neighbours, and rows whose least candidate
    exceeds it, get `sentinel`.  Each panel array goes through M1, whose
    per-slot rows are combined by an amin scatter; the remainder through
    spmv_ell with I32_MIN_PLUS, or, where the weights were factored into
    hyb.scale (uniform weights, no remainder values), min-select plus the
    scale on the rows that have remainder neighbours.

    Contract, as the JAX function's: edges deduped (dense cells sum
    duplicates) and weights positive integers (a zero cell is no edge);
    the constant-value scale must be integral."""
    from gardenia_tpu_torch.ops.semiring import I32_MIN_PLUS, I32_MIN_SELECT2
    from gardenia_tpu_torch.ops.spmv import spmv_ell

    num_cols = int(x.shape[0])
    qx = (num_cols + LANES - 1) // LANES
    mb = (num_rows + LANES - 1) // LANES
    scale = int(round(hyb.scale))
    assert scale == hyb.scale, \
        "min-plus needs integral weights (fractional scale factored)"
    x = x.to(torch.int32)
    x2d = x.new_full((qx * LANES,), sentinel)
    x2d[:num_cols] = x
    x2d = x2d.view(qx, LANES)
    y2d = x.new_full((mb, LANES), sentinel)
    for p in hyb.dense:
        part = _minselect.dense_panel_minplus(p.panel, p.src, x2d, sentinel,
                                              scale)
        y2d.scatter_reduce_(0, p.rows.long()[:, None].expand_as(part), part,
                            "amin")
    y = y2d.view(-1)[:num_rows]
    if hyb.rem.buckets:
        if hyb.rem.buckets[0].vals is not None:
            y = spmv_ell(hyb.rem, x, semiring=I32_MIN_PLUS,
                         num_rows=num_rows, init=y)
        else:
            # scale-factored uniform weights: min_j (x[j] + c) =
            # min_j x[j] + c on the rows with remainder neighbours
            ysel = spmv_ell(hyb.rem, x, semiring=I32_MIN_SELECT2,
                            num_rows=num_rows)
            none = ysel == I32_MIN_SELECT2.zero
            y = torch.minimum(y, torch.where(none, sentinel, ysel + scale))
    return y
