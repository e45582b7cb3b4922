"""2D edge partitioning with a halo exchange — multi-device TC, SCC and VC,
the torch counterpart of gardenia_tpu/parallel/two_d.py.

The 1D solvers (parallel/color.py, parallel/tc.py) replicate the edges
and split only the work.  Here the EDGES are split over an (r x c) mesh
(parallel/mesh.make_mesh2d):
  * vertices split into r row ranges and c column ranges;
  * rank (i, k) owns the panel A[R_i, C_k], about nnz / (r c) edges;
  * per-vertex reductions travel as short vectors: a source-side scatter
    is summed over axis "c" and gathered over axis "r" (_merge_src), a
    destination-side one the mirror image (_merge_dst), so a sweep moves
    m/r + m/c per rank instead of 2m;
  * TC needs whole adjacency rows restricted to one column range: the
    ranks all-gather their panels' CSRs along axis "r" (the halo), after
    which every rank of mesh column k holds N+(v) ∩ C_k for every v, and
    its wedges are probed there by torch.searchsorted.
Every rank builds only its own panel from the host graph.  The solvers
take a Mesh2D, or the 1D Mesh of the group (its Mesh2D is made then).
The JAX package's one-hot row select (`rowsel`) is plain indexing.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.parallel.mesh import Mesh2D, make_mesh2d
from gardenia_tpu_torch.solvers.scc import SCCResult
from gardenia_tpu_torch.solvers.vc import VCResult


class Edges2D(NamedTuple):
    """Panel edge lists stacked (r, c, P) with GLOBAL vertex ids, sentinel
    m on the padding; rows_per / cols_per are the range widths."""
    src: np.ndarray           # i32[r, c, P]
    dst: np.ndarray           # i32[r, c, P]
    rows_per: int
    cols_per: int


def _ranges(m: int, r: int, c: int):
    return -(-m // r), -(-m // c)


def partition_edges_2d(g, r: int, c: int) -> Edges2D:
    """Every panel's edges, stacked (the JAX package's form; a rank takes
    its own with panel_edges)."""
    m = g.m
    rows_per, cols_per = _ranges(m, r, c)
    src = np.repeat(np.arange(m, dtype=np.int64), np.diff(g.rowptr))
    dst = np.asarray(g.colidx, np.int64)
    key = (src // rows_per) * c + dst // cols_per
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=r * c)
    pmax = T.round_up(max(int(counts.max()), 8), 8)
    s = np.full((r * c, pmax), m, np.int32)
    d = np.full((r * c, pmax), m, np.int32)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(src)) - offs[key[order]]
    s[key[order], slot] = src[order]
    d[key[order], slot] = dst[order]
    return Edges2D(s.reshape(r, c, pmax), d.reshape(r, c, pmax),
                   rows_per, cols_per)


def panel_edges(g, mesh: Mesh2D):
    """(src, dst) i64 of this rank's panel A[R_i, C_k], global ids in CSR
    order (partition_edges_2d's slice without its padding), on the rank's
    device."""
    (r, c), (i, k) = mesh.shape, mesh.coords
    rows_per, cols_per = _ranges(g.m, r, c)
    lo, hi = min(g.m, i * rows_per), min(g.m, (i + 1) * rows_per)
    e0, e1 = int(g.rowptr[lo]), int(g.rowptr[hi])
    src = np.repeat(np.arange(lo, hi, dtype=np.int64),
                    np.diff(g.rowptr[lo:hi + 1]))
    dst = np.asarray(g.colidx[e0:e1], np.int64)
    mine = dst // cols_per == k
    return (torch.from_numpy(src[mine]).to(mesh.device),
            torch.from_numpy(dst[mine]).to(mesh.device))


def _as_2d(mesh) -> Mesh2D:
    return mesh if isinstance(mesh, Mesh2D) else make_mesh2d(mesh=mesh)


class _Sweeps:
    """The scatters of one rank's panel and their merges over the mesh."""

    def __init__(self, g, mesh: Mesh2D):
        (r, c), (i, k) = mesh.shape, mesh.coords
        self.mesh, self.m = mesh, g.m
        self.rows_per, self.cols_per = _ranges(g.m, r, c)
        self.src, self.dst = panel_edges(g, mesh)
        self.src_l = self.src - i * self.rows_per       # local row slot
        self.dst_l = self.dst - k * self.cols_per       # local column slot

    @staticmethod
    def _scatter(idx, n: int, x, op: str):
        z = torch.zeros(n, dtype=x.dtype, device=x.device)
        if op == "add":
            return z.index_add_(0, idx, x)
        return z.scatter_reduce_(0, idx, x, "amax")

    def scat_src(self, x, op: str = "add"):
        return self._scatter(self.src_l, self.rows_per, x, op)

    def scat_dst(self, x, op: str = "add"):
        return self._scatter(self.dst_l, self.cols_per, x, op)

    def merge_src(self, v):
        """(rows_per,) row-range partials -> the replicated (m,) sum: a
        sum over axis "c", then a gather over axis "r"."""
        return self.mesh.all_gather(self.mesh.all_reduce(v, "c"),
                                    "r")[:self.m]

    def merge_dst(self, v):
        """The mirror image: a sum over "r", a gather over "c"."""
        return self.mesh.all_gather(self.mesh.all_reduce(v, "r"),
                                    "c")[:self.m]

    def edge_active(self, active):
        return active[self.src] & active[self.dst]


def scc_solver_dist2d(g, *, mesh, max_rounds: int = None) -> SCCResult:
    """FB-Trim SCC of directed g with 2D-partitioned edges on every rank
    of mesh: the fixed point of solvers/scc.py and
    parallel/color.scc_solver_dist, the per-vertex reductions riding the
    short row and column axes; the pivot of each vertex's SCC on every
    rank."""
    mesh = _as_2d(mesh)
    m, dev = g.m, mesh.device
    if max_rounds is None:
        max_rounds = m + 2
    sw = _Sweeps(g, mesh)
    src, dst = sw.src, sw.dst
    vid = torch.arange(m, dtype=torch.int32, device=dev)
    root = torch.full((m,), -1, dtype=torch.int32, device=dev)
    active = torch.ones(m, dtype=torch.bool, device=dev)
    it = 0
    while bool(active.any()) and it < max_rounds:
        while True:                                  # trim
            ea = sw.edge_active(active).to(torch.int32)
            ind = sw.merge_dst(sw.scat_dst(ea))
            outd = sw.merge_src(sw.scat_src(ea))
            trivial = active & ((ind == 0) | (outd == 0))
            root = torch.where(trivial, vid, root)
            active = active & ~trivial
            if not bool(trivial.any()):
                break
        color = torch.where(active, vid, -1)         # forward max-id colour
        changed = bool(active.any())
        while changed:
            x = torch.where(sw.edge_active(active), color[src], -1)
            pushed = mesh.all_reduce(mesh.all_gather(
                sw.scat_dst(x, "max"), "c")[:m], "r", "max")
            new = torch.where(active, torch.maximum(color, pushed), color)
            changed = bool((new != color).any())
            color = new
        reach = active & (color == vid)              # backward closure
        changed = bool(reach.any())
        while changed:
            ea = sw.edge_active(active) & (color[src] == color[dst])
            x = (ea & reach[dst]).to(torch.int32)
            new = reach | (sw.merge_src(sw.scat_src(x)) > 0)
            changed = bool((new != reach).any())
            reach = new
        in_scc = active & reach
        root = torch.where(in_scc, color, root)
        active = active & ~in_scc
        it += 1
    return SCCResult(root, it)


def vc_solver_dist2d(g, *, mesh, max_color: int = T.MAXCOLOR) -> VCResult:
    """Gebremedhin-Manne colouring of symmetric g with 2D-partitioned
    edges on every rank of mesh: the forbidden-colour table is built a
    row range at a time (rows_per x C), summed over axis "c" and gathered
    over axis "r"; the fixed point of solvers/vc.py's speculative
    rounds."""
    mesh = _as_2d(mesh)
    m, dev, C = g.m, mesh.device, max_color
    sw = _Sweeps(g, mesh)
    src, dst, src_l, rows_per = sw.src, sw.dst, sw.src_l, sw.rows_per
    colors = torch.zeros(m, dtype=torch.int32, device=dev)
    active = torch.ones(m, dtype=torch.bool, device=dev)
    it = 0
    while bool(active.any()):
        cd = colors[dst].long()
        flat = torch.where(active[src], src_l * C + cd, rows_per * C)
        forb_l = torch.zeros(rows_per * C + 1, dtype=torch.int32,
                             device=dev)
        forb_l[flat] = 1
        forb = mesh.all_gather(mesh.all_reduce(forb_l[:-1], "c"), "r")
        fit = torch.argmin(forb[:m * C].view(m, C), dim=1).to(torch.int32)
        colors = torch.where(active, fit, colors)
        conf = (src < dst) & (colors[src] == colors[dst])
        confl = torch.zeros(rows_per + 1, dtype=torch.int32, device=dev)
        confl[torch.where(conf, src_l, rows_per)] = 1
        active = sw.merge_src(confl[:-1]) > 0
        it += 1
    ncol = int(colors.max()) + 1 if m else 0
    return VCResult(colors, ncol, it, {"speculative": it}, C, 0)


def tc_solver_dist2d(g, *, mesh, chunk: int = 1 << 14,
                     wedge_budget: int = 1 << 22) -> int:
    """The triangle count of symmetric g over column-restricted panels of
    its DAG with a row-axis halo, on every rank of mesh.

    Rank (i, k) holds the DAG panel A[R_i, C_k] as a CSR over its
    rows_per rows (neighbour lists sorted, padded to the widest panel's
    length as the JAX package pads them); one all_gather along "r"
    assembles N+(v) ∩ C_k for every v.  Its wedges are those of the DAG
    arcs in edge slice i (the slices balance the wedge space, as the JAX
    package cuts them) whose third vertex w lies in C_k, and a wedge
    (u, v, w) closes when w is in N+(v) ∩ C_k: a torch.searchsorted of
    the key v * m + w in the halo's sorted keys.  The counts are summed
    over "c" and then "r".  wedge_budget wedges are made at a time;
    chunk, the JAX package's inner loop step, has no counterpart."""
    from gardenia_tpu_torch.solvers.tc import wedge_index
    mesh = _as_2d(mesh)
    (r, c), (i, k) = mesh.shape, mesh.coords
    dev = mesh.device
    dag = g._dev(("oriented",), g.oriented)
    m, nnz = dag.m, dag.nnz
    if nnz == 0:
        return 0
    rows_per, cols_per = _ranges(m, r, c)
    rp = np.asarray(dag.rowptr, np.int64)
    src_all = np.repeat(np.arange(m, dtype=np.int64), np.diff(rp))
    dst_all = np.asarray(dag.colidx, np.int64)
    # this rank's panel as a local CSR, sorted by (row, column)
    key = (src_all // rows_per) * c + dst_all // cols_per
    emax = T.round_up(max(int(np.bincount(key, minlength=r * c).max()), 8),
                      8)
    mine = key == i * c + k
    order = np.lexsort((dst_all[mine], src_all[mine]))
    p_src = src_all[mine][order] - i * rows_per
    p_rowptr = np.zeros(rows_per + 1, np.int64)
    p_rowptr[1:] = np.cumsum(np.bincount(p_src, minlength=rows_per))
    p_colidx = np.full(emax, m, np.int64)
    p_colidx[:len(p_src)] = dst_all[mine][order]
    # the halo: the column panel C_k of every row range
    rp_g = mesh.all_gather(torch.from_numpy(p_rowptr).to(dev)[None], "r")
    ci_g = mesh.all_gather(torch.from_numpy(p_colidx).to(dev), "r")
    lens = (rp_g[:, 1:] - rp_g[:, :-1]).reshape(-1)[:m]
    rows = torch.repeat_interleave(torch.arange(m, device=dev), lens)
    real = torch.arange(emax, device=dev)[None, :] < rp_g[:, -1:]
    keys = rows * m + ci_g.view(r, emax)[real]      # ascending
    # edge slice i: a contiguous range of DAG arcs, wedges [w0, w1)
    wpe = np.diff(rp)[src_all]
    cum = np.cumsum(wpe)
    per_slice = int(cum[-1]) / r
    slice_of_edge = np.minimum((cum - wpe) // max(per_slice, 1),
                               r - 1).astype(np.int64)
    index = wedge_index(dag, dev)
    rowptr, colidx, srcs, first = index[:4]
    e0, e1 = np.searchsorted(slice_of_edge, [i, i + 1])
    w0, w1 = int(cum[e0 - 1]) if e0 else 0, int(cum[e1 - 1]) if e1 else 0
    total = torch.zeros((), dtype=torch.int64, device=dev)
    step = max(1, wedge_budget)
    for start in range(w0, w1, step):
        j = torch.arange(start, min(w1, start + step), dtype=torch.int64,
                         device=dev)
        e = torch.searchsorted(first, j, right=True) - 1
        v = colidx[e].long()
        w = colidx[rowptr[srcs[e]] + (j - first[e])].long()
        q = (v * m + w)[w // cols_per == k]
        if len(keys):
            pos = torch.searchsorted(keys, q).clamp(max=len(keys) - 1)
            total += (keys[pos] == q).sum()
    total = mesh.all_reduce(mesh.all_reduce(total, "c"), "r")
    return int(total)
