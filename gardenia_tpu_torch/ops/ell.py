"""Degree-bucketed ELL ("slab") layout — torch counterpart of
gardenia_tpu/ops/ell.py.

`build_ell` is a numpy-only copy of the reference builder: the port
imports nothing of gardenia_tpu.  Same constants (the port's copy
core/types.py), same arrays; tests hold the two equal.

Layout: each bucket holds
  row_ids i32[R]      destination row of each virtual row (sentinel m = pad)
  cols    i32[W, R]   gather indices into x (sentinel n = pad slot)
  vals    f32[W, R]   edge values (optional; pad 0)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gardenia_tpu_torch.core import types as T


@dataclasses.dataclass
class EllBucket:
    row_ids: torch.Tensor            # i32[R]
    cols: torch.Tensor               # i32[W, R]
    vals: Optional[torch.Tensor]     # f32[W, R] or None

    def to(self, device) -> "EllBucket":
        return EllBucket(self.row_ids.to(device), self.cols.to(device),
                         None if self.vals is None else self.vals.to(device))


@dataclasses.dataclass
class EllMatrix:
    buckets: Tuple[EllBucket, ...]

    def to(self, device) -> "EllMatrix":
        return EllMatrix(tuple(b.to(device) for b in self.buckets))


def build_ell(rowptr: np.ndarray,
              colidx: np.ndarray,
              weights: Optional[np.ndarray] = None,
              *,
              num_cols: int,
              width_cap: int = T.ELL_WIDTH_CAP,
              min_width: int = T.ELL_MIN_WIDTH,
              lane_align: int = T.LANES) -> EllMatrix:
    """Host-side blocking of a CSR matrix into degree-bucketed ELL slabs
    (CPU tensors; `.to(device)` uploads)."""
    m = len(rowptr) - 1
    rowptr = np.asarray(rowptr, dtype=np.int64)
    deg = np.diff(rowptr)
    # --- split rows into virtual rows of width <= width_cap ---------------
    n_chunks = -(-deg // width_cap)          # ceil; deg 0 -> 0 chunks
    total = int(n_chunks.sum())
    if total == 0:
        return EllMatrix(buckets=())
    vrow_dst = np.repeat(np.arange(m, dtype=T.VID_DTYPE), n_chunks)
    row_first = np.repeat(rowptr[:-1], n_chunks)
    chunk_base = np.repeat(np.cumsum(n_chunks) - n_chunks, n_chunks)
    cc = np.arange(total, dtype=np.int64) - chunk_base
    starts = row_first + cc * width_cap
    widths = np.minimum(np.repeat(deg, n_chunks) - cc * width_cap,
                        width_cap).astype(np.int64)
    # --- bucket by padded width: exact narrow widths, pow2 beyond ---------
    pow2_w = 1 << np.ceil(np.log2(np.maximum(widths, 1))).astype(np.int64)
    pad_w = np.maximum(min_width,
                       np.where(widths <= T.ELL_EXACT_WIDTH, widths,
                                pow2_w))
    buckets = []
    col_sentinel = T.VID_DTYPE(num_cols)
    row_sentinel = T.VID_DTYPE(m)
    for w in np.unique(pad_w):
        sel = pad_w == w
        r = int(sel.sum())
        rp = T.round_up(r, lane_align)
        b_starts = starts[sel]
        b_widths = widths[sel]
        offs = np.arange(w, dtype=np.int64)
        gather_idx = b_starts[:, None] + offs[None, :]        # (r, w)
        valid = offs[None, :] < b_widths[:, None]
        np.clip(gather_idx, 0, len(colidx) - 1, out=gather_idx)
        cols = np.where(valid, colidx[gather_idx], col_sentinel)
        cols = np.concatenate(
            [cols, np.full((rp - r, w), col_sentinel, T.VID_DTYPE)], axis=0)
        row_ids = np.concatenate(
            [vrow_dst[sel], np.full(rp - r, row_sentinel, T.VID_DTYPE)])
        vals = None
        if weights is not None:
            vals = np.where(valid, weights[gather_idx], 0).astype(np.float32)
            vals = np.concatenate(
                [vals, np.zeros((rp - r, w), np.float32)], axis=0)
            vals = torch.from_numpy(np.ascontiguousarray(vals.T))  # (w, rp)
        buckets.append(EllBucket(
            row_ids=torch.from_numpy(
                np.ascontiguousarray(row_ids, dtype=T.VID_DTYPE)),
            cols=torch.from_numpy(
                np.ascontiguousarray(cols.T.astype(T.VID_DTYPE))),  # (w, rp)
            vals=vals))
    return EllMatrix(buckets=tuple(buckets))


def from_jax_ell(ell) -> EllMatrix:
    """Carry a gardenia_tpu EllMatrix (JAX or numpy arrays) across as CPU
    tensors, through numpy."""
    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))
    return EllMatrix(tuple(EllBucket(t(b.row_ids), t(b.cols), t(b.vals))
                           for b in ell.buckets))
