"""Wedge-stream sort-groupby — rank-restricted streams; torch counterpart of
gardenia_tpu/mining/wedgestream.py (reference behaviour:
mining/motif_dfs/omp_formula.cc aggregates per-edge triangle counts and
codegrees with thread-local hash maps, include/cmap.h).

Vertices are degree-relabelled (core/relabel.py: new id 0 = highest
degree, a strict total order).

MAIN stream: wedge (a, v, b) — endpoints a < b, centre v — enumerated iff
v > a, only centres ranked above the min-rank endpoint; grouped by (a, b):
  * 4-cycles: each non-induced 4-cycle gives exactly one centre pair to
    exactly one run (the one of the diagonal holding the cycle's global
    min vertex), so the sum over runs of C(#wedges, 2) counts every cycle
    once;
  * tri_r(e): an edge's entry sorts first in its run; the run's wedges
    after it are its common neighbours ranked above a.
MISS stream: t_miss(a, b) = |{w < a : w in N(a) and w in N(b)}|, a
sort-join: for each edge (a, b) one query (w, b) per w in row a's prefix
(neighbours < a), beside a presence entry for every edge; a query's run
starts with a presence entry iff (w, b) is an edge.
tri(e) = tri_r(e) + t_miss(e), summing to 3T over the edges.

The host parts (`_relabel_edges`, `_segment_cover`, `_host_partitions`,
`_host_query_partitions` and the constants) are copies of the
reference's, held equal by tests/test_torch_motif.py.  The two device
programs are torch functions here: segment rows sliced by one gather,
one sort of a packed int64 key a partition (MAIN: a << 32 | b << 1 |
is_wedge, so a run's edge entry sorts first; MISS: w << 32 | b << 1 |
is_query, so the presence entry does; ids are below 2^31, so the packing
is exact), runs numbered by a cumsum over their starts, and the
drop-mode scatters as index_put_ / index_add_ over the compacted edge
and query entries (a scatter of every padding and wedge slot into one
drop slot piles some 10^8 writes onto one address a partition).  The
sums are int64, so the reference's 14-bit hi/lo split and its BLOCK do
not come across, nor its pow2 padding of shapes.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core.views import _key

SEG_WIDTHS = (32, 128)
WEDGE_PAYLOAD = 1 << 30           # payload tag for wedge + padding slots
SENT_KEY = np.int32(np.iinfo(np.int32).max)  # padding key (> any vid)
# a padding slot's packed key, (SENT_KEY, SENT_KEY, 1): sorts after every
# real entry
SENT_PACKED = (int(SENT_KEY) << 32) | (int(SENT_KEY) << 1) | 1
# what one partition's buffers may hold: keys, sorted keys, the sort's
# order, payload and scan temporaries are about 40 B a slot, so 2^30 slots
# take some 43 GB of an 80 GB card.  A larger partition (one a-value's
# wedges past it) raises StreamTooLarge, and motif_solver takes the host
# oracles.
MAX_PART_SLOTS = 1 << 30


class StreamTooLarge(ValueError):
    """A stream partition outgrows MAX_PART_SLOTS, or the edges the wedge
    payload tag: the streams cannot hold this graph."""


class _Partition(NamedTuple):
    segs: Tuple                   # per width: (starts, lens, bcast...) i32
    ua: np.ndarray                # undirected edge endpoints (a < b, new ids)
    ub: np.ndarray
    eid: np.ndarray               # undirected edge ids (ORIGINAL sel order)
    n_slots: int


def _relabel_edges(g):
    """Degree-rank relabeled graph + undirected edges in new-id space.

    eid keeps the ORIGINAL (src < dst over g's CSR) enumeration order so
    per-edge results need no inverse mapping."""
    from gardenia_tpu_torch.core.relabel import relabeled
    rel = relabeled(g)
    rp = np.asarray(g.rowptr, np.int64)
    ci = np.asarray(g.colidx, np.int64)
    srcs = np.repeat(np.arange(g.m, dtype=np.int64), np.diff(rp))
    sel = srcs < ci
    no = rel.new_of_old.astype(np.int64)
    u2, v2 = no[srcs[sel]], no[ci[sel]]
    ua = np.minimum(u2, v2).astype(np.int32)
    ub = np.maximum(u2, v2).astype(np.int32)
    eid = np.arange(len(ua), dtype=np.int32)
    return rel.graph, ua, ub, eid


def _segment_cover(start_all, len_all, extra):
    """Cover (start, len) row slices with full-128 + remainder segments.
    `extra` is a list of per-slice broadcast arrays carried to every
    covering segment (e.g. the wedge's a, or a query's (b, eid))."""
    w_small = SEG_WIDTHS[0]
    nfull = len_all // 128
    rem = len_all - nfull * 128
    f_sel = nfull > 0
    f_rep = np.repeat(np.flatnonzero(f_sel), nfull[f_sel])
    f_t = (np.arange(len(f_rep), dtype=np.int64)
           - np.repeat((np.cumsum(nfull[f_sel]) - nfull[f_sel]),
                       nfull[f_sel]))
    r_sel = rem > 0
    start = np.concatenate([start_all[f_rep] + 128 * f_t,
                            start_all[r_sel] + 128 * nfull[r_sel]])
    length = np.concatenate([np.full(len(f_rep), 128, np.int64),
                             rem[r_sel]])
    bcast = [np.concatenate([x[f_rep], x[r_sel]]) for x in extra]
    width = np.where(length <= w_small, w_small, 128)
    return start, length, width, bcast


def _host_partitions(g2, ua, ub, eid, budget_slots: int):
    """MAIN-stream partitions: a-keyed so (a,b) runs never cross."""
    rp = np.asarray(g2.rowptr, np.int64)
    ci = np.asarray(g2.colidx, np.int64)
    m, nnz = g2.m, g2.nnz
    deg = np.diff(rp)
    srcs = np.repeat(np.arange(m, dtype=np.int64), deg)
    i_in = np.arange(nnz, dtype=np.int64) - rp[srcs]
    wpe = deg[srcs] - 1 - i_in
    # RESTRICTION: the slot's neighbor a = ci pairs with the row suffix
    # only when a < center (rows are id-sorted, so every pair's min
    # endpoint is the slot's own value)
    sel = (wpe > 0) & (ci < srcs)
    a_all = ci[sel]
    pos0 = (rp[srcs] + i_in + 1)[sel]
    start, length, width, (aa,) = _segment_cover(pos0, wpe[sel], [a_all])

    # partition cut points on a-value so padded totals fit the budget
    slots_per_a = np.zeros(m + 1, np.int64)
    np.add.at(slots_per_a, aa, width)
    np.add.at(slots_per_a, ua.astype(np.int64), 1)
    cum = np.cumsum(slots_per_a)
    parts = []
    alo = 0
    base = 0
    while alo <= m:
        ahi = int(np.searchsorted(cum, base + budget_slots, side="right"))
        ahi = max(ahi, alo + 1)
        ssel = (aa >= alo) & (aa < ahi)
        esel = (ua >= alo) & (ua < ahi)
        segs = []
        for w in SEG_WIDTHS:
            wsel = ssel & (width == w)
            segs.append((start[wsel].astype(np.int32),
                         length[wsel].astype(np.int32),
                         aa[wsel].astype(np.int32)))
        n_slots = int(sum(len(s[0]) * w for s, w in zip(segs, SEG_WIDTHS))
                      + esel.sum())
        parts.append(_Partition(tuple(segs), ua[esel], ub[esel],
                                eid[esel], n_slots))
        base = cum[ahi - 1]
        alo = ahi
        if ahi > m or base >= cum[-1]:
            break
    return [p for p in parts if p.n_slots]


def _host_query_partitions(g2, ua, ub, eid, budget_slots: int):
    """MISS-stream partitions: per edge (a,b) a query segment over row
    a's prefix (neighbors < a).  Any cut is correct (presence entries
    are replicated into every partition), so cut sequentially."""
    rp = np.asarray(g2.rowptr, np.int64)
    ci = np.asarray(g2.colidx, np.int64)
    m, nnz = g2.m, g2.nnz
    deglt = np.zeros(m, np.int64)
    srcs = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    np.add.at(deglt, srcs, (ci < srcs).astype(np.int64))
    qlen = deglt[ua.astype(np.int64)]
    qsel = qlen > 0
    start, length, width, (qb, qe) = _segment_cover(
        rp[ua.astype(np.int64)[qsel]], qlen[qsel],
        [ub[qsel].astype(np.int64), eid[qsel].astype(np.int64)])
    # edge order as-is: slice locality buys nothing on HBM, and a ~50M
    # host argsort costs a minute on this host (np.sort 0.8 M keys/s)
    sw = np.cumsum(width)
    parts = []
    lo = 0
    while lo < len(start):
        hi = int(np.searchsorted(sw, (sw[lo - 1] if lo else 0)
                                 + budget_slots, side="right"))
        hi = max(hi, lo + 1)
        segs = []
        for w in SEG_WIDTHS:
            wsel = width[lo:hi] == w
            segs.append((start[lo:hi][wsel].astype(np.int32),
                         length[lo:hi][wsel].astype(np.int32),
                         qb[lo:hi][wsel].astype(np.int32),
                         qe[lo:hi][wsel].astype(np.int32)))
        n_slots = int(sum(len(s[0]) * w
                          for s, w in zip(segs, SEG_WIDTHS)))
        parts.append(tuple(segs) + (n_slots,))
        lo = hi
    return parts


def _segment_keys(colidx, segs):
    """(rows, valid, broadcast arrays) of each width's uploaded segments:
    rows (n, w) int64 holds colidx[start + lane], valid (n, w) its lanes
    below the segment's length."""
    out = []
    for arrs, w in zip(segs, SEG_WIDTHS):
        if arrs is None:
            continue
        starts, lens, *bcast = (a.long() for a in arrs)
        lane = torch.arange(w, dtype=torch.int64, device=colidx.device)
        pos = (starts[:, None] + lane).clamp_max(colidx.numel() - 1)
        out.append((colidx[pos].long(), lane < lens[:, None], bcast))
    return out


def _sorted_stream(keys, pays):
    """The entries sorted by their packed key, and their runs of equal
    (x, y): (key, payload, each entry's run, each run's first and last
    position).  Runs are numbered by a cumsum over the run starts, which
    the card scans in one pass (torch.cummax over one long row is a
    single block's serial scan there)."""
    key, order = torch.sort(torch.cat(keys))
    pay = torch.cat(pays)[order]
    xy = key >> 1
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = xy[1:] != xy[:-1]
    run = torch.cumsum(first, 0) - 1
    starts = torch.nonzero(first).flatten()
    ends = torch.empty_like(starts)
    ends[:-1] = starts[1:] - 1
    ends[-1] = key.numel() - 1
    return key, pay, run, starts, ends


def _main_pass(colidx, tri, part) -> torch.Tensor:
    """Sum over the partition's (a, b) runs of C(#wedges, 2) (an int64
    scalar tensor); sets tri[eid] to the wedges of each edge's run."""
    segs, ua, ub, eid = part
    keys = [(ua.long() << 32) | (ub.long() << 1)]
    pays = [eid.long()]
    for rows, ok, (av,) in _segment_keys(colidx, segs):
        key = (av[:, None] << 32) | (rows << 1) | 1
        keys.append(torch.where(ok, key, SENT_PACKED).reshape(-1))
        pays.append(torch.full((key.numel(),), WEDGE_PAYLOAD,
                               dtype=torch.int64, device=key.device))
    key, pay, run, starts, ends = _sorted_stream(keys, pays)
    is_edge = (key & 1) == 0
    # a run's wedges: its entries but its edge, which sorts first; the
    # padding slots' run counts none
    wedges = ends - starts + 1 - is_edge[starts].long()
    wedges = torch.where(key[starts] != SENT_PACKED, wedges, 0)
    pairs = (wedges * (wedges - 1) // 2).sum()
    e = torch.nonzero(is_edge).flatten()
    tri[pay[e]] = ends[run[e]] - e
    return pairs


def _miss_pass(colidx, tri, segs, pres) -> None:
    """tri[eid] += t_miss: a query (w, b) of edge eid is found iff its
    run starts with the presence entry of the edge (w, b)."""
    keys = [pres]
    pays = [torch.full((pres.numel(),), -1, dtype=torch.int64,
                       device=pres.device)]
    for rows, ok, (bv, ev) in _segment_keys(colidx, segs):
        keys.append(torch.where(ok, (rows << 32) | (bv[:, None] << 1) | 1,
                                SENT_PACKED).reshape(-1))
        pays.append(torch.where(ok, ev[:, None], WEDGE_PAYLOAD).reshape(-1))
    key, pay, run, starts, _ = _sorted_stream(keys, pays)
    found = ((key[starts] & 1) == 0)[run]
    q = torch.nonzero(found & (pay >= 0) & (pay < WEDGE_PAYLOAD)).flatten()
    tri.index_add_(0, pay[q], torch.ones_like(q))


def _partitions(g, budget_slots: int):
    """(relabelled graph, ua, ub, eid, MAIN partitions, MISS partitions),
    cached on g."""
    g2, ua, ub, eid = g._dev(("wedgestream_relabel",),
                             lambda: _relabel_edges(g))
    parts = g._dev(("wedgestream_parts", budget_slots),
                   lambda: _host_partitions(g2, ua, ub, eid, budget_slots))
    qparts = g._dev(("wedgestream_qparts", budget_slots),
                    lambda: _host_query_partitions(g2, ua, ub, eid,
                                                   budget_slots))
    return g2, ua, ub, eid, parts, qparts


def partition_counts(g, budget_slots: int = 1 << 27) -> dict:
    """The numbers of MAIN and MISS partitions of g's streams."""
    parts, qparts = _partitions(g, budget_slots)[4:]
    return {"n_parts": len(parts), "n_qparts": len(qparts)}


def _streams(g, budget_slots: int, dev):
    """The partitions' arrays on dev (int32; a width with no segment is
    None), the relabelled colidx and the presence keys, cached on g;
    StreamTooLarge where a partition outgrows MAX_PART_SLOTS or the edges
    the payload tag."""
    g2, ua, ub, eid, parts, qparts = _partitions(g, budget_slots)
    n_u = len(ua)
    if n_u >= WEDGE_PAYLOAD:
        raise StreamTooLarge(f"{n_u} edges reach the wedge payload tag "
                             f"{WEDGE_PAYLOAD}")
    biggest = max([p.n_slots for p in parts]
                  + [qp[-1] + n_u for qp in qparts])
    if biggest > MAX_PART_SLOTS:
        raise StreamTooLarge(f"a stream partition of {biggest} slots > "
                             f"{MAX_PART_SLOTS}")

    def mk():
        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        def segs(arrs):
            return tuple(tuple(up(a) for a in s) if len(s[0]) else None
                         for s in arrs)
        main = [(segs(p.segs), up(p.ua), up(p.ub), up(p.eid))
                for p in parts]
        miss = [segs(qp[:-1]) for qp in qparts]
        pres = up((ua.astype(np.int64) << 32) | (ub.astype(np.int64) << 1))
        return up(g2.colidx), main, miss, pres
    return g._dev(_key("wedgestream", dev, budget_slots), mk)


def wedge_stream_stats(g, budget_slots: int = 1 << 27, device="cuda"):
    """Returns (c_non, tri_u, ua, ub): the number of non-induced 4-cycles
    (= sum_{a<b} C(codeg(a,b), 2) / 2) and FULL per-undirected-edge
    triangle counts (int64) in the graph's (src < dst) edge order, as the
    reference's; ua and ub are None, as there.  Raises StreamTooLarge
    where a partition outgrows MAX_PART_SLOTS."""
    if g.nnz == 0:
        return 0, np.zeros(0, np.int64), None, None
    dev = resolve_device(device)
    colidx, main, miss, pres = _streams(g, budget_slots, dev)
    tri = torch.zeros(pres.numel(), dtype=torch.int64, device=dev)
    total_pairs = torch.zeros((), dtype=torch.int64, device=dev)
    for part in main:
        total_pairs += _main_pass(colidx, tri, part)
    for segs in miss:
        _miss_pass(colidx, tri, segs, pres)
    return int(total_pairs), tri.cpu().numpy(), None, None


def motif4_aggregates(g, device="cuda"):
    """(c_non, d_non, tri_v, tri_undirected) for the 4-census formula —
    device streams instead of the host sort + membership sweep."""
    c_non, tri_u, _, _ = wedge_stream_stats(g, device=device)
    rp = np.asarray(g.rowptr, np.int64)
    ci = np.asarray(g.colidx, np.int64)
    srcs = np.repeat(np.arange(g.m, dtype=np.int64), np.diff(rp))
    e_sel = srcs < ci
    ua, ub = srcs[e_sel], ci[e_sel]
    t = tri_u.astype(np.int64)
    d_non = int((t * (t - 1) // 2).sum())
    tri_v = np.zeros(g.m, np.int64)
    np.add.at(tri_v, ua, t)
    np.add.at(tri_v, ub, t)
    tri_v //= 2
    return c_non, d_non, tri_v, tri_u
