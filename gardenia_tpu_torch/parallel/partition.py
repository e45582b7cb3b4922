"""1D row-range partitioning of a graph into per-shard ELL slabs and hybrid
layouts — the torch counterpart of gardenia_tpu/parallel/partition.py.

Rows split into contiguous ranges, one a shard, in equal vertex counts or
balanced by edge count (the reference Scheduler's workload estimate,
src/common/scheduler.cc:14-215).  Each shard owns the edges into its
range.  Every shard is padded to `rows_per_shard` slots and ALL vertex
ids, the column ids inside the shards included, live in that padded
space (padded_id = shard * rows_per_shard + (v - bounds[shard])), so the
all-gathered operand is addressed without shard offsets.

Two forms:
  - the stacked ones, `partition_ell_1d`, `partition_hybrid_1d` and
    `partition_hybrid_stacked`, hold every shard's arrays with a leading
    shard axis, padded to common shapes, as the JAX package's do (its
    shard_map needs them so); host arrays, numpy where numpy has the
    dtype and torch CPU tensors for the dense panels (numpy has no
    bfloat16), held equal to the JAX package's;
  - `ell_shard` and `hybrid_shard`: one shard's matrix alone, as the rank
    that owns it builds it (a rank holds only its own shard), with the
    row sentinels of its ELL slabs at rows_per_shard.  It equals its slice
    of the stacked form without the padding slots.
Both build through the port's ops/ell.build_ell and ops/bsr.build_hybrid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.ops.bsr import DensePanel, HybridMatrix, build_hybrid
from gardenia_tpu_torch.ops.ell import EllBucket, EllMatrix, build_ell

_PANEL_RANK = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


@dataclasses.dataclass
class RowRanges:
    """Contiguous row ranges of n shards, each padded to rows_per_shard."""
    bounds: np.ndarray        # i64[n+1] row-range boundaries
    rows_per_shard: int       # mb: padded rows a shard

    @property
    def n_shards(self) -> int:
        return len(self.bounds) - 1

    def padded_size(self) -> int:
        return self.n_shards * self.rows_per_shard

    def shard_range(self, s: int) -> Tuple[int, int]:
        return int(self.bounds[s]), int(self.bounds[s + 1])

    def to_padded(self, arr: np.ndarray, fill) -> np.ndarray:
        """Scatter a global per-vertex array into the padded layout."""
        out = np.full(self.padded_size(), fill, arr.dtype)
        for s in range(self.n_shards):
            lo, hi = self.shard_range(s)
            base = s * self.rows_per_shard
            out[base:base + (hi - lo)] = arr[lo:hi]
        return out

    def from_padded(self, arr):
        """Gather a padded-layout array (numpy or torch, padded along dim
        0) back to global vertex order."""
        mb = self.rows_per_shard
        parts = [arr[s * mb:s * mb + (hi - lo)]
                 for s, (lo, hi) in enumerate(map(self.shard_range,
                                                  range(self.n_shards)))]
        if isinstance(arr, torch.Tensor):
            return torch.cat(parts)
        return np.concatenate([np.asarray(p) for p in parts])

    def pad_map(self, ids: np.ndarray) -> np.ndarray:
        """Map global vertex ids to padded coordinates."""
        return _remap(np.asarray(ids), self.bounds,
                      self.rows_per_shard).astype(T.VID_DTYPE)


@dataclasses.dataclass
class ShardedEll:
    """Per-bucket arrays stacked over shards: (row_ids i32[n, R], LOCAL
    row, sentinel rows_per_shard; cols i32[n, W, R], PADDED-GLOBAL column,
    sentinel n * rows_per_shard; vals f32[n, W, R] or None)."""
    buckets: Tuple[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]], ...]


@dataclasses.dataclass
class Partition1D(RowRanges):
    ell: ShardedEll = None


@dataclasses.dataclass
class ShardedHybrid(RowRanges):
    """The hybrid layout stacked over shards: per width bucket (width,
    panel int8|bf16|f32[n, R, 128, W*128] (a CPU tensor), src i32[n, R, W]
    PADDED-GLOBAL operand block column, rows i32[n, R] LOCAL block row,
    sentinel rows_per_shard / 128), and the ELL remainder in the same
    padded coordinates."""
    panels: Tuple[Tuple[int, torch.Tensor, np.ndarray, np.ndarray], ...] = ()
    rem: ShardedEll = None


@dataclasses.dataclass
class StackedHybrid(RowRanges):
    """One HybridMatrix whose every leaf has a leading shard axis (CPU
    tensors); padded slots hold zero panels on block row 0 (a no-op under
    add and min) and the remainder's sentinels are (rows_per_shard,
    n * rows_per_shard)."""
    hyb: HybridMatrix = None


@dataclasses.dataclass
class Shard:
    """One shard's matrix as its rank holds it (an EllMatrix or a
    HybridMatrix, CPU tensors), its row range [lo, hi) and the layout's
    row ranges."""
    mat: object
    lo: int
    hi: int
    ranges: RowRanges


def edge_balanced_bounds(rowptr: np.ndarray, n_shards: int) -> np.ndarray:
    """Contiguous vertex ranges with ~equal edge counts (the Scheduler's
    workload estimate, scheduler.cc:14-215)."""
    m = len(rowptr) - 1
    nnz = int(rowptr[-1])
    targets = (np.arange(1, n_shards) * nnz) // n_shards
    cuts = np.searchsorted(rowptr, targets, side="left")
    bounds = np.concatenate([[0], cuts, [m]]).astype(np.int64)
    return np.maximum.accumulate(bounds)


def shard_bounds(rowptr: np.ndarray, n_shards: int,
                 balance: str) -> np.ndarray:
    """i64[n+1] row ranges: balanced by edges, or equal vertex counts."""
    if balance == "edges":
        return edge_balanced_bounds(rowptr, n_shards)
    if balance != "vertices":
        raise ValueError(f"unknown balance {balance!r}")
    m = len(rowptr) - 1
    mb0 = -(-m // n_shards)
    return np.minimum(np.arange(n_shards + 1, dtype=np.int64) * mb0, m)


def _remap(cols: np.ndarray, bounds: np.ndarray, mb: int) -> np.ndarray:
    """Global vertex ids to padded coordinates (int64)."""
    s = np.searchsorted(bounds, cols, side="right") - 1
    return (s * mb + (cols - bounds[s])).astype(np.int64)


def _direction(g, reverse: bool, weighted: bool, ax):
    """(rowptr, colidx, weights or None) of g's chosen direction; ax
    overrides the weights (and implies weighted)."""
    rp = g.in_rowptr if reverse else g.rowptr
    ci = g.in_colidx if reverse else g.colidx
    if ax is not None:
        return rp, ci, np.asarray(ax, np.float32)
    w = (g.in_weights if reverse else g.weights) if weighted else None
    if weighted and w is None:
        w = np.ones(len(ci), np.float32)
    return rp, ci, w


def _shard_csr(rp, ci, w, bounds, mb: int, s: int):
    """Shard s's CSR (local rows, padded-global columns) and weights."""
    lo, hi = int(bounds[s]), int(bounds[s + 1])
    sub_rp = rp[lo:hi + 1] - rp[lo] if hi > lo else np.zeros(1, rp.dtype)
    sub_ci = _remap(ci[rp[lo]:rp[hi]], bounds, mb).astype(T.VID_DTYPE)
    sub_w = None if w is None else np.asarray(w[rp[lo]:rp[hi]], np.float32)
    return sub_rp, sub_ci, sub_w


def _ell_mb(bounds) -> int:
    return T.round_up(max(1, int(np.diff(bounds).max())), T.SUBLANES)


def _hybrid_mb(bounds) -> int:
    return T.round_up(max(T.LANES, int(np.diff(bounds).max())), T.LANES)


def _drop_row_sentinels(ell: EllMatrix, local_rows: int, mb: int) -> None:
    """build_ell's row sentinel of a shard is its row count: move it to
    mb, where spmv_ell drops it."""
    for b in ell.buckets:
        b.row_ids[b.row_ids >= local_rows] = mb


def ell_shard(g, n_shards: int, s: int, *, reverse: bool = False,
              weighted: bool = False, ax=None, balance: str = "vertices",
              width_cap: int = T.ELL_WIDTH_CAP) -> Shard:
    """Shard s of partition_ell_1d, alone: its ELL slabs (CPU tensors)."""
    rp, ci, w = _direction(g, reverse, weighted, ax)
    bounds = shard_bounds(rp, n_shards, balance)
    mb = _ell_mb(bounds)
    sub_rp, sub_ci, sub_w = _shard_csr(rp, ci, w, bounds, mb, s)
    ell = build_ell(sub_rp, sub_ci, sub_w, num_cols=n_shards * mb,
                    width_cap=width_cap)
    lo, hi = int(bounds[s]), int(bounds[s + 1])
    _drop_row_sentinels(ell, hi - lo, mb)
    return Shard(ell, lo, hi, RowRanges(bounds, mb))


def hybrid_shard(g, n_shards: int, s: int, *, reverse: bool = False,
                 weighted: bool = False, ax=None, balance: str = "edges",
                 dense_threshold: int = 16) -> Shard:
    """Shard s of the 1D hybrid partition, alone: its hybrid layout (CPU
    tensors) over the padded-global columns.  Pass a degree-relabelled
    graph for block locality (core/relabel.py).

    Unweighted (the default), it is shard s of partition_hybrid_1d.  With
    weighted= or ax= (edge values in the chosen direction's CSR order,
    implying weighted), it is shard s of partition_hybrid_stacked: the
    constant-value scale and the panel dtype that the stacked form fixes
    across the shards come from the global weights (stacked_plan), so the
    rank builds its own shard only."""
    rp, ci, w = _direction(g, reverse, weighted, ax)
    bounds = shard_bounds(rp, n_shards, balance)
    mb = _hybrid_mb(bounds)
    factor, dt = True, None
    if w is not None:
        factor, dt = stacked_plan(rp, ci, w, bounds, mb, dense_threshold)
    sub_rp, sub_ci, sub_w = _shard_csr(rp, ci, w, bounds, mb, s)
    hyb = build_hybrid(sub_rp, sub_ci, sub_w, num_cols=n_shards * mb,
                       dense_threshold=dense_threshold, factor_scale=factor)
    if dt is not None:
        hyb.dense = tuple(DensePanel(p.panel.to(dt), p.src, p.rows, p.width)
                          for p in hyb.dense)
    lo, hi = int(bounds[s]), int(bounds[s + 1])
    _drop_row_sentinels(hyb.rem, hi - lo, mb)
    return Shard(hyb, lo, hi, RowRanges(bounds, mb))


def stacked_plan(rp, ci, w, bounds, mb: int,
                 dense_threshold: int) -> Tuple[bool, torch.dtype]:
    """(factor_scale, panel dtype) that partition_hybrid_stacked fixes
    across the shards of weighted rows: factor_scale is False where the
    shards' constant-value scales differ, and the dtype is the widest of
    the shards' panels, found from the global edges without building any
    panel.  A cell's value is the sum of its edges' weights (1 for an
    edge whose shard's weights were factored); the dtype rule of
    build_hybrid is monotone in its cells, so the widest shard's dtype is
    the rule applied to every shard's dense cells at once."""
    n = len(bounds) - 1
    cuts = rp[bounds]
    vals = np.array(w, np.float32)         # the shards' weights, as built
    segs = [vals[cuts[s]:cuts[s + 1]] for s in range(n)]
    # build_hybrid(factor_scale=True) factors a shard whose weights all
    # equal one nonzero value, and stores its counts
    uniform = [len(x) > 0 and x[0] != 0 and bool(np.all(x == x[0]))
               for x in segs]
    factor = len({float(x[0]) if u else 1.0
                  for x, u in zip(segs, uniform)}) == 1
    if factor:
        for x, u in zip(segs, uniform):
            if u:
                x[:] = 1.0
    rows = np.repeat(np.arange(len(rp) - 1, dtype=np.int64), np.diff(rp))
    prow = _remap(rows, bounds, mb)
    pcol = _remap(np.asarray(ci, np.int64), bounds, mb)
    sb_span = (n * mb >> 7) + 2
    blk = (prow >> 7) * sb_span + (pcol >> 7)
    _, inv, cnt = np.unique(blk, return_inverse=True, return_counts=True)
    dense = cnt[inv] >= dense_threshold
    if not dense.any():
        return factor, torch.int8
    # each cell's sum in f32, its edges in CSR order, as build_hybrid sums
    key = prow[dense] * (n * mb) + pcol[dense]
    order = np.argsort(key, kind="stable")
    key = key[order]
    starts = np.flatnonzero(np.r_[True, key[1:] != key[:-1]])
    sums = np.add.reduceat(vals[dense][order], starts)
    integral = bool((sums == np.round(sums)).all())
    if integral and sums.max() <= 127 and sums.min() >= -128:
        return factor, torch.int8
    if integral and np.abs(sums).max() <= 256:
        return factor, torch.bfloat16
    return factor, torch.float32


def partition_ell_1d(g, n_shards: int, *, reverse: bool = False,
                     weighted: bool = False, ax=None,
                     balance: str = "vertices",
                     width_cap: int = T.ELL_WIDTH_CAP) -> Partition1D:
    """Split g's rows into n contiguous ranges and ELL-block each range.

    ax: optional edge values in the chosen direction's CSR edge order,
    overriding the graph's own weights (the SpMV main's synthetic Ax,
    src/spmv/main.cc:28-37); implies weighted."""
    rp, ci, w = _direction(g, reverse, weighted, ax)
    bounds = shard_bounds(rp, n_shards, balance)
    mb = _ell_mb(bounds)
    pad_n = n_shards * mb
    mats = []
    for s in range(n_shards):
        sub_rp, sub_ci, sub_w = _shard_csr(rp, ci, w, bounds, mb, s)
        mats.append(build_ell(sub_rp, sub_ci, sub_w, num_cols=pad_n,
                              width_cap=width_cap))
    return Partition1D(bounds, mb, _unify_ell(mats, bounds, mb, pad_n,
                                              w is not None))


def _unify_ell(shard_mats, bounds, mb, pad_n, weighted) -> ShardedEll:
    """Stack per-shard EllMatrix buckets into common shapes: the same
    width set, the same padded R a width."""
    n_shards = len(shard_mats)
    widths = sorted({b.cols.shape[0] for em in shard_mats
                     for b in em.buckets})
    buckets = []
    for wdt in widths:
        per = [next((b for b in em.buckets if b.cols.shape[0] == wdt), None)
               for em in shard_mats]
        rmax = max((b.row_ids.shape[0] for b in per if b is not None),
                   default=0)
        rmax = T.round_up(max(rmax, T.LANES), T.LANES)
        rids = np.full((n_shards, rmax), mb, T.VID_DTYPE)
        cols = np.full((n_shards, wdt, rmax), pad_n, T.VID_DTYPE)
        vals = np.zeros((n_shards, wdt, rmax), np.float32) \
            if weighted else None
        for s, b in enumerate(per):
            if b is None:
                continue
            r = b.row_ids.shape[0]
            row_ids = b.row_ids.numpy()
            local_rows = int(bounds[s + 1] - bounds[s])
            rids[s, :r] = np.where(row_ids >= local_rows, mb, row_ids)
            cols[s, :, :r] = b.cols.numpy()
            if weighted:
                vals[s, :, :r] = b.vals.numpy()
        buckets.append((rids, cols, vals))
    return ShardedEll(tuple(buckets))


def _stack_panels(hybs, n_shards: int, dtype_of, row_fill: int):
    """Per width: the shards' panel arrays padded to the widest R (zero
    panels), their src and rows tables (rows padded with row_fill)."""
    out = []
    for wdt in sorted({p.width for hy in hybs for p in hy.dense}):
        per = [next((p for p in hy.dense if p.width == wdt), None)
               for hy in hybs]
        dt = dtype_of([p.panel.dtype for p in per if p is not None])
        rmax = max(p.panel.shape[0] for p in per if p is not None)
        panel = torch.zeros((n_shards, rmax, T.LANES, wdt * T.LANES),
                            dtype=dt)
        srct = np.zeros((n_shards, rmax, wdt), np.int32)
        rows = np.full((n_shards, rmax), row_fill, np.int32)
        for s, pn in enumerate(per):
            if pn is None:
                continue
            r = pn.panel.shape[0]
            panel[s, :r] = pn.panel.to(dt)
            srct[s, :r] = pn.src.numpy()
            rows[s, :r] = pn.rows.numpy()
        out.append((int(wdt), panel, srct, rows))
    return out


def partition_hybrid_1d(g, n_shards: int, *, reverse: bool = False,
                        balance: str = "edges",
                        dense_threshold: int = 16) -> ShardedHybrid:
    """Split rows into n contiguous ranges and build the hybrid layout of
    each range against the padded-global column space (pass a
    degree-relabelled graph: without hub clustering the dense part
    degenerates).  Shard row counts round up to a multiple of 128 so that
    padded-global ids tile into operand blocks; each width's panel arrays
    pad R to the widest shard's (f32 where the shards' dtypes differ), with
    the row sentinel rows_per_shard / 128."""
    rp, ci, _ = _direction(g, reverse, False, None)
    bounds = shard_bounds(rp, n_shards, balance)
    mb = _hybrid_mb(bounds)
    pad_n = n_shards * mb
    hybs = []
    for s in range(n_shards):
        sub_rp, sub_ci, _ = _shard_csr(rp, ci, None, bounds, mb, s)
        hybs.append(build_hybrid(sub_rp, sub_ci, None, num_cols=pad_n,
                                 dense_threshold=dense_threshold))
    panels = _stack_panels(
        hybs, n_shards,
        lambda dts: torch.float32 if len(set(dts)) > 1 else dts[0],
        mb // T.LANES)
    rem = _unify_ell([hy.rem for hy in hybs], bounds, mb, pad_n,
                     weighted=False)
    return ShardedHybrid(bounds, mb, tuple(panels), rem)


def partition_hybrid_stacked(g, n_shards: int, *, reverse: bool = False,
                             weighted: bool = False, ax=None,
                             balance: str = "edges",
                             dense_threshold: int = 16) -> StackedHybrid:
    """Split rows into n contiguous ranges and build ONE shard-stacked
    HybridMatrix: panels unified to common widths, R and dtype across the
    shards, the ELL remainder as in partition_ell_1d.  Weights as
    build_hybrid takes them, except that the constant-value scale must be
    one value: when the shards' scales disagree, every shard is rebuilt
    with factor_scale=False.  ax: per-edge values in the chosen
    direction's CSR order; implies weighted."""
    rp, ci, w = _direction(g, reverse, weighted, ax)
    bounds = shard_bounds(rp, n_shards, balance)
    mb = _hybrid_mb(bounds)
    pad_n = n_shards * mb

    def build_all(factor_scale):
        return [build_hybrid(*_shard_csr(rp, ci, w, bounds, mb, s),
                             num_cols=pad_n, dense_threshold=dense_threshold,
                             factor_scale=factor_scale)
                for s in range(n_shards)]

    hybs = build_all(True)
    scales = {hy.scale for hy in hybs}
    if len(scales) > 1:
        hybs = build_all(False)
        scales = {1.0}
    dts = [p.panel.dtype for hy in hybs for p in hy.dense]
    dt = max(dts, key=_PANEL_RANK.get) if dts else torch.int8
    panels = tuple(
        DensePanel(panel, torch.from_numpy(srct), torch.from_numpy(rows), wdt)
        for wdt, panel, srct, rows in _stack_panels(
            hybs, n_shards, lambda _: dt, 0))
    weighted_rem = any(b.vals is not None
                       for hy in hybs for b in hy.rem.buckets)
    sharded = _unify_ell([hy.rem for hy in hybs], bounds, mb, pad_n,
                         weighted=weighted_rem)
    rem = EllMatrix(tuple(
        EllBucket(torch.from_numpy(r), torch.from_numpy(c),
                  None if v is None else torch.from_numpy(v))
        for r, c, v in sharded.buckets))
    empty = torch.zeros((n_shards, 0), dtype=torch.int32)
    hyb = HybridMatrix(panels, rem, empty, empty.clone(), None,
                       scale=float(next(iter(scales))))
    return StackedHybrid(bounds, mb, hyb)
