"""TC — triangle counting over the DAG orientation; torch counterpart of
gardenia_tpu/solvers/tc.py (reference src/tc/{omp_base.cc,gpu_base.cu}):
total = sum over DAG edges (u, v) of |N+(u) & N+(v)|, each triangle
counted once.

Variants:
  'rotate' (default) — the hybrid bitmap + width-classed chunk-pair path.
      The host prep (numpy) packs the DAG's adjacency into 128-lane chunk
      rows, sends hub-hub edges to a bitmap and prunes the other edges'
      chunk pairs into width classes W = 8..128.  On the device: kernel
      H1 counts the hub pairs, K3 (search count) the classes
      W < MERGE_MIN_W, K4 (hash count) the rest — one launch per class
      over the whole class stream (ops/tc_count.py), each class ordered
      by its shared row at upload — and the per-pair counts are summed
      in int64.
  'bsearch' — chunked wedge enumeration with vectorised binary-search
      membership (ops/intersect.py), plain torch.

`_chunk_table`, `_win_searchsorted`, `_pow2ceil_arr`, `_pair_streams`,
`_build_bitmap` and the constants are copies of the reference's, because
the reference module imports jax; tests/test_torch_tc.py holds them
equal array by array.  The reference's `PAIR_SLICE_LIMIT`/`_pack_stream`
slicing and padding kept TPU indices in int32 and shapes static; the
kernels here take 64-bit pair offsets and any stream length, so neither
is ported, and the lane-reversed table of the bitonic merge is not built.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core.views import _key
from gardenia_tpu_torch.ops import tc_count
from gardenia_tpu_torch.ops.intersect import membership_counts
from gardenia_tpu_torch.ops.tc_count import LANES, ROT_WIDTHS

HUB_THRESHOLD = 128        # deg+ >= this -> bitmap intersection path
BITMAP_BUDGET_WORDS = 1 << 27   # <= 512 MB of uint32 bitmap rows
# width classes at or above this go through K4, the others through K3.
# The card's crossover (the reference's constant is 32): chip_smoke.py
# [6] times both kernels on every class of R-MAT-20, and in one run on an
# NVIDIA H100 80GB HBM3 at 700.00 W K3 led at W8, W16 and W32 (0.117,
# 0.175, 0.200 ms against K4's 0.260, 0.343, 0.274) and K4 at W64 and
# W128 (0.903, 1.798 against 0.931, 2.048)
MERGE_MIN_W = 64


def _chunk_table(dag):
    """Pack the DAG adjacency into (C, 128) rows padded with -1; vertex v
    owns rows [cstart[v], cstart[v+1])."""
    deg = np.diff(dag.rowptr)
    n_chunks = -(-deg // LANES)
    cstart = np.concatenate([[0], np.cumsum(n_chunks)])
    C = int(cstart[-1])
    table = np.full((max(C, 1), LANES), -1, np.int32)
    # scatter edges into rows
    eidx = np.arange(dag.nnz, dtype=np.int64)
    src = np.repeat(np.arange(dag.m, dtype=np.int64), deg)
    off = eidx - dag.rowptr[src]
    rows = cstart[src] + off // LANES
    lanes = off % LANES
    table[rows, lanes] = np.asarray(dag.colidx)
    return table, cstart.astype(np.int64), n_chunks.astype(np.int64)


def _win_searchsorted(arr, starts, lens, vals, side):
    """Vectorized windowed searchsorted: for each i, the insertion
    point of vals[i] in the ascending window arr[starts[i] :
    starts[i]+lens[i]].  Manual binary search — numpy has no windowed
    form; ~log2(max window) vectorized passes."""
    lo = np.zeros(len(vals), np.int64)
    hi = lens.astype(np.int64).copy()
    while True:
        active = lo < hi
        if not active.any():
            return lo
        mid = (lo + hi) >> 1
        # clamp: empty windows (lens 0) are inactive but still indexed,
        # and a trailing zero-chunk vertex has starts == len(arr)
        a = arr[np.minimum(starts + np.minimum(mid,
                                               np.maximum(lens - 1, 0)),
                           len(arr) - 1)]
        go_right = (a < vals) if side == "left" else (a <= vals)
        lo = np.where(active & go_right, mid + 1, lo)
        hi = np.where(active & ~go_right, mid, hi)


def _pow2ceil_arr(x):
    return (2 ** np.ceil(np.log2(np.maximum(x, 1)))).astype(np.int64)


def _pair_streams(dag, cstart, n_chunks, clo, chi, fill, edge_sel):
    """Pruned, width-classed chunk-pair streams for the DAG edges in
    `edge_sel` (bool mask): {W: (cu i32[n], cv i32[n])}.

    Staircase pruning: rows are sorted, so chunk i of N+(u) can only
    intersect the chunks of N+(v) whose [min, max] range overlaps it.
    Width classes: each pair is swapped so cu is the side with the
    smaller lane fill, and classed by W = pow2ceil(min fill) (>= 8), so
    cu's ids all lie in its first W lanes (see the reference's docstring
    for the rotation argument)."""
    m = dag.m
    deg = np.diff(dag.rowptr)
    src = np.repeat(np.arange(m, dtype=np.int64), deg)[edge_sel]
    dst = np.asarray(dag.colidx, np.int64)[edge_sel]
    cu_n = n_chunks[src]
    e2 = np.repeat(np.arange(len(src), dtype=np.int64), cu_n)
    i2 = np.arange(len(e2), dtype=np.int64) - \
        np.repeat(np.cumsum(cu_n) - cu_n, cu_n)
    urow = cstart[src[e2]] + i2
    vs = cstart[dst[e2]]
    cvn = n_chunks[dst[e2]]
    jlo = _win_searchsorted(chi, vs, cvn, clo[urow], "left")
    jhi = _win_searchsorted(clo, vs, cvn, chi[urow], "right")
    cnt = np.maximum(jhi - jlo, 0)
    total = int(cnt.sum())
    base = np.cumsum(cnt) - cnt
    pp = np.repeat(np.arange(len(cnt), dtype=np.int64), cnt)
    off = np.arange(total, dtype=np.int64) - base[pp]
    cu = urow[pp]
    cv = vs[pp] + jlo[pp] + off
    fu, fv = fill[cu], fill[cv]
    swap = fu > fv
    cu2 = np.where(swap, cv, cu).astype(np.int32)
    cv2 = np.where(swap, cu, cv).astype(np.int32)
    W = np.maximum(8, _pow2ceil_arr(np.minimum(fu, fv)))
    out = {}
    for w in ROT_WIDTHS:
        sel = W == w
        if sel.any():
            out[int(w)] = (cu2[sel], cv2[sel])
    return out


def _build_bitmap(dag, src, dst, deg):
    """Hub-hub edges go through exact bitmap intersection: after degree
    relabelling every out-neighbour of a vertex with deg+ >=
    HUB_THRESHOLD is itself a top-degree vertex, so all hub out-lists live
    in a small id prefix [0, U), and N+(u) & N+(v) is
    popcount(bmp[u] & bmp[v]) over U bits.

    Returns (bmp uint32[H+1, wpad], hu, hv, hh_edge_mask) or None when
    no hubs exist / the bitmap would blow the budget (e.g. natural ids
    without relabelling, or near-regular graphs)."""
    hub = deg >= HUB_THRESHOLD
    if not hub.any():
        return None
    sel = hub[src]
    if not sel.any():
        return None
    U = int(dst[sel].max()) + 1
    words = -(-U // 32)
    wpad = -(-words // LANES) * LANES
    H = int(hub.sum())
    if (H + 1) * wpad > BITMAP_BUDGET_WORDS:
        return None
    rank = (np.cumsum(hub) - 1).astype(np.int64)
    bmp = np.zeros((H + 1, wpad), np.uint32)   # +1: zero sentinel row
    v = dst[sel]
    np.bitwise_or.at(bmp, (rank[src[sel]], v >> 5),
                     np.uint32(1) << (v & 31).astype(np.uint32))
    hh = hub[src] & hub[dst]
    hu = rank[src[hh]].astype(np.int32)
    hv = rank[dst[hh]].astype(np.int32)
    return bmp, hu, hv, hh


def tc_prep(dag, use_bitmap: bool = True):
    """Host prep of the rotate path, as the reference's `prep` builds it
    (tc.py:380-395): (table i32[C+1, 128] whose last row is an all-pad
    sentinel, {W: (cu, cv)}, (bmp, hu, hv) or None, sentinel row C)."""
    table_h, cstart, n_chunks = _chunk_table(dag)
    clo = table_h[:, 0].astype(np.int64)
    chi = table_h.max(axis=1).astype(np.int64)
    fill = (table_h >= 0).sum(axis=1).astype(np.int64)
    deg = np.diff(dag.rowptr)
    src = np.repeat(np.arange(dag.m, dtype=np.int64), deg)
    dst = np.asarray(dag.colidx, np.int64)
    bm = _build_bitmap(dag, src, dst, deg) if use_bitmap else None
    hh = bm[3] if bm is not None else np.zeros(dag.nnz, bool)
    streams = _pair_streams(dag, cstart, n_chunks, clo, chi, fill, ~hh)
    th = np.concatenate([table_h, np.full((1, LANES), -1, np.int32)], axis=0)
    return th, streams, (bm[0], bm[1], bm[2]) if bm is not None else None, \
        len(th) - 1


@dataclasses.dataclass
class TCData:
    """The rotate path's prep on one device."""
    table: torch.Tensor                      # i32[C+1, 128]
    # W -> (cu, cv), ordered by (cv, cu)
    streams: Dict[int, Tuple[torch.Tensor, torch.Tensor]]
    # (bmp as i32[H+1, wpad], hu, hv) when the hub bitmap is built; the
    # hub stream keeps tc_prep's order, which is hu's (DAG-edge order)
    bitmap: Optional[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def by_second_row(cu: torch.Tensor, cv: torch.Tensor):
    """(cu, cv) permuted into (cv, cu) order, on their device, so that the
    pairs sharing a row cv are consecutive and K3 and K4 stage it once
    per run.  The per-pair counts are summed, so no result depends on
    the order."""
    key = (cv.to(torch.int64) << 32) | cu.to(torch.int64)
    perm = torch.sort(key).indices
    return cu[perm].contiguous(), cv[perm].contiguous()


def tc_data(dag, use_bitmap: bool, device) -> TCData:
    """tc_prep of dag uploaded to `device` (each width class ordered by
    by_second_row there), cached on dag."""
    def mk():
        th, streams, bm, _ = tc_prep(dag, use_bitmap)

        def up(a):
            return torch.from_numpy(a).to(device)
        return TCData(
            up(th), {W: by_second_row(up(cu), up(cv))
                     for W, (cu, cv) in streams.items()},
            None if bm is None or not len(bm[1])
            else (up(bm[0].view(np.int32)), up(bm[1]), up(bm[2])))
    return dag._dev(_key("tc_data", device, use_bitmap, HUB_THRESHOLD,
                         BITMAP_BUDGET_WORDS), mk)


def tc_dag(g, *, presorted_dag: bool = False, use_relabel: bool = True):
    """The degree-ordered DAG that the rotate path counts on: g itself
    when presorted, else the orientation of g (degree-relabelled first
    when use_relabel; counts are invariant under relabelling)."""
    if presorted_dag:
        return g
    if use_relabel:
        from gardenia_tpu_torch.core.relabel import relabeled
        g = relabeled(g).graph
    return g._dev(("oriented",), g.oriented)


def tc_rotate(g, *, chunk: int = 1 << 13, presorted_dag: bool = False,
              use_bitmap: bool = True, use_relabel: bool = True,
              device="cuda") -> int:
    """Hybrid bitmap + width-classed chunk-pair triangle count.  `chunk`
    is the plain versions' step (CPU tensors); a kernel takes its whole
    class stream in one launch."""
    dev = resolve_device(device)
    dag = tc_dag(g, presorted_dag=presorted_dag, use_relabel=use_relabel)
    if dag.nnz == 0:
        return 0
    data = tc_data(dag, use_bitmap, dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    if data.bitmap is not None:
        bmp, hu, hv = data.bitmap
        total += torch.sum(tc_count.bitmap_count(
            bmp, hu, hv, chunk=max(1, min(chunk, 2048))), dtype=torch.int64)
    for W in sorted(data.streams):
        cu, cv = data.streams[W]
        if W >= MERGE_MIN_W:
            counts = tc_count.merge_count(data.table, cu, cv, W,
                                          chunk=chunk)
        else:
            counts = tc_count.rot_count(data.table, cu, cv, W, chunk=chunk)
        total += torch.sum(counts, dtype=torch.int64)
    return int(total)


def tc_bsearch(g, *, chunk: int = 1 << 20, presorted_dag: bool = False,
               device="cuda") -> int:
    """Wedge-space binary-search variant: for each DAG edge (u, v) and
    each w in N+(u), test w in N+(v).  Wedge indices are int64, so the
    reference's int32 edge-range slicing is not needed."""
    dev = resolve_device(device)
    dag = g if presorted_dag else g._dev(("oriented",), g.oriented)
    if dag.nnz == 0:
        return 0
    index = wedge_index(dag, dev)
    return int(count_wedges(index, 0, index[4], chunk))


def wedge_index(dag, dev):
    """(rowptr i64, colidx, src of each arc, first wedge of each arc i64
    with the total appended, total wedges, search rounds) of a DAG with
    arcs, on dev and cached there: the wedge space that tc_bsearch and
    parallel/tc enumerate (arc e = (u, v) owns deg(u) wedges)."""
    def mk():
        deg = np.diff(dag.rowptr)
        src = np.repeat(np.arange(dag.m, dtype=np.int32), deg)
        first = np.concatenate([[0], np.cumsum(deg[src].astype(np.int64))])

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        rounds = max(1, int(np.ceil(np.log2(max(2, deg.max() + 1)))) + 1)
        return (up(dag.rowptr.astype(np.int64)), up(dag.colidx), up(src),
                up(first), int(first[-1]), rounds)
    return dag._dev(_key("tc_bsearch", dev), mk)


def count_wedges(index, lo: int, hi: int, chunk: int) -> torch.Tensor:
    """int64 scalar tensor: the closed wedges among wedges [lo, hi) of
    wedge_index's space, `chunk` wedges a step."""
    rowptr, colidx, src, first, _, rounds = index
    chunk = max(1, chunk)
    total = torch.zeros((), dtype=torch.int64, device=colidx.device)
    for start in range(lo, hi, chunk):
        j = torch.arange(start, min(hi, start + chunk), dtype=torch.int64,
                         device=colidx.device)
        e = torch.searchsorted(first, j, right=True) - 1
        u, v = src[e], colidx[e]
        w = colidx[rowptr[u] + (j - first[e])]
        total += membership_counts(rowptr, colidx, w, v,
                                   search_rounds=rounds)
    return total


def tc_solver(g, *, variant: str = "rotate", device="cuda", **kw) -> int:
    """Reference entry TCSolver(g, total) (src/tc/tc.h:7).  g must be
    symmetric (undirected); the DAG orientation is applied internally.
    Returns a python int triangle count."""
    if variant == "rotate":
        return tc_rotate(g, device=device, **kw)
    if variant == "bsearch":
        return tc_bsearch(g, device=device, **kw)
    raise ValueError(f"unknown TC variant {variant!r}")
