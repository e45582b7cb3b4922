"""SymGS — multi-colour symmetric Gauss-Seidel smoother; torch counterpart
of gardenia_tpu/solvers/symgs.py (reference src/symgs/{symgs.h,
omp_base.cc,main.cc}).

One application sweeps the colour blocks forward, then backward; within a
block no two rows are adjacent (a proper colouring), so its rows update
together:

  x[i] = (b[i] - sum_{j in N(i)} A[ij] x[j]) / diag[i]   for i in block c

(rows with diag 0 keep x[i]).  The JAX solver runs 2 x num_colors masked
SpMVs over the whole matrix.  Here the rows are sorted by colour, as the
reference driver sorts them into `indices` + `color_offsets`
(src/symgs/main.cc:52-61): a stable argsort of the colours, one
colour-ordered CSR of the rows with their values, and x kept in that
order, so a block is a contiguous slice of rows and edges — a gather of
x at its columns, a product with its values, a segment sum per row and
one write of its rows.  The order of rows inside a block is free, so
this computes the same function.  The colour-ordered matrix is built on
the host and cached per graph and per id of Ax, colors, b and diag (the
SpMV solver's cache rule, Graph._dev's retain=).

As in the JAX solver, the reference driver's implicit zero diagonal is
replaced by a diagonally dominant system (diag = degree + 1) so that the
smoother does real work.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.utils.profiler import spanned


class SymGSResult(NamedTuple):
    x: torch.Tensor        # f32[m], original vertex order
    num_colors: int


@dataclasses.dataclass
class ColorOrdered:
    """The colour-ordered system on one device."""
    order: torch.Tensor    # i64[m]: row of the original id at each position
    col: torch.Tensor      # i64[nnz]: column positions in the ordered x
    val: torch.Tensor      # f32[nnz]
    b: torch.Tensor        # f32[m], ordered
    diag: torch.Tensor     # f32[m], ordered
    update: torch.Tensor   # bool[m], ordered: diag != 0
    blocks: list           # per colour: (first row, end row, its rows'
    #                        edge offsets from its first edge i64[rows+1],
    #                        first edge, end edge); empty colours left out


def color_ordered(g, Ax, b, diag, colors, device) -> ColorOrdered:
    """The system (g's structure with values Ax, b, diag) with its rows
    sorted stably by colour and its columns renamed to positions."""
    m = g.m
    colors = np.asarray(colors)
    order = np.argsort(colors, kind="stable")
    pos = np.empty(m, np.int64)
    pos[order] = np.arange(m)
    rp = np.asarray(g.rowptr, np.int64)
    lens = np.diff(rp)[order]
    rowptr = np.zeros(m + 1, np.int64)
    np.cumsum(lens, out=rowptr[1:])
    # the edge slots of each ordered row, in the row's CSR order
    eidx = np.repeat(rp[order] - rowptr[:-1], lens) + np.arange(
        rowptr[-1], dtype=np.int64)
    col = pos[np.asarray(g.colidx, np.int64)[eidx]]
    val = np.asarray(Ax, np.float32)[eidx]
    counts = np.bincount(colors, minlength=int(colors.max()) + 1 if m else 0)
    ends = np.cumsum(counts)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    blocks = [(int(e - c), int(e), up(rowptr[e - c:e + 1] - rowptr[e - c]),
               int(rowptr[e - c]), int(rowptr[e]))
              for c, e in zip(counts, ends) if c]
    diag = np.asarray(diag, np.float32)[order]
    return ColorOrdered(up(order), up(col), up(val),
                        up(np.asarray(b, np.float32)[order]), up(diag),
                        up(diag != 0), blocks)


def sweep(sys: ColorOrdered, x: torch.Tensor, block) -> None:
    """Update the rows of one colour block of the ordered x in place."""
    r0, r1, offsets, e0, e1 = block
    prod = sys.val[e0:e1] * x[sys.col[e0:e1]]
    rsum = torch.segment_reduce(prod, "sum", offsets=offsets, initial=0.0)
    xs = x[r0:r1]
    torch.where(sys.update[r0:r1], (sys.b[r0:r1] - rsum) / sys.diag[r0:r1],
                xs, out=xs)


def fill_inputs(g, Ax=None, x=None, b=None, diag=None, colors=None, *,
                device="cuda"):
    """(Ax, x, b, diag, colors), numpy, with the missing ones filled as the
    JAX solver fills them (gardenia_tpu/solvers/symgs.py:39-60): Ax, x, b
    uniform [0, 1) from default_rng(13), in that order, each drawn only
    when not given; diag = degree + 1; the port's colouring on `device`."""
    rng = np.random.default_rng(13)
    if Ax is None:
        Ax = rng.random(g.nnz).astype(np.float32)
    if x is None:
        x = rng.random(g.m).astype(np.float32)
    if b is None:
        b = rng.random(g.m).astype(np.float32)
    if diag is None:
        diag = (g.degrees + 1).astype(np.float32)
    if colors is None:
        from gardenia_tpu_torch.solvers.vc import vc_solver
        colors = vc_solver(g, device=device).colors.cpu().numpy()
    return Ax, x, b, diag, colors


def default_inputs(g, device):
    """fill_inputs(g) of the CLI and the bench (gardenia_tpu/cli.py:
    203-223, bench.py:500-522), cached on the graph, so that later calls
    hand the solver the same arrays and it reuses its ordered system."""
    return g._dev(("torch", "symgs_inputs", str(torch.device(device))),
                  lambda: fill_inputs(g, device=device))


@spanned("solve.symgs")
def symgs_solver(g, Ax: Optional[np.ndarray] = None,
                 x: Optional[np.ndarray] = None,
                 b: Optional[np.ndarray] = None,
                 diag: Optional[np.ndarray] = None,
                 colors: Optional[np.ndarray] = None, *,
                 device="cuda") -> SymGSResult:
    """Reference entry SymGSSolver(g, indices, Ax, x, b, color_offsets)
    (src/symgs/symgs.h:31); the missing inputs are filled by fill_inputs,
    which colours the graph with the port's vc_solver when colors is None
    (main.cc:52-61 composes VCSolver the same way)."""
    dev = resolve_device(device)
    Ax, x, b, diag, colors = fill_inputs(g, Ax, x, b, diag, colors,
                                         device=dev)
    num_colors = int(np.max(colors)) + 1
    sys = g._dev(("torch", "symgs", str(dev), id(Ax), id(b), id(diag),
                  id(colors)),
                 lambda: color_ordered(g, Ax, b, diag, colors, dev),
                 retain=(Ax, b, diag, colors))
    xo = torch.as_tensor(np.asarray(x, np.float32)).to(dev)[sys.order]
    # forward (omp_base.cc:38-39), then backward (:40-41)
    for block in sys.blocks + sys.blocks[::-1]:
        sweep(sys, xo, block)
    out = torch.empty_like(xo)
    out[sys.order] = xo
    return SymGSResult(out, num_colors)
