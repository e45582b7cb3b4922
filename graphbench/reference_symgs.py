"""The plain reference for SymGS: HPCG's system on the benchmark's own CSR,
smoothed in float64 by plain PyTorch, independent of the port (nothing of
gardenia_tpu_torch is imported, nothing the port made is read but the
colouring under test).

The matrix is the cleaned graph (reference.clean_csr) with `diagonal` on
the diagonal and `off_diagonal` on every arc; HPCG's right-hand side is
the row sum, b_i = diagonal + off_diagonal * deg_i, so the exact solution
is all ones.

  symgs    — one multi-colour symmetric Gauss-Seidel application: for
             c = 0 .. C-1, then C-1 .. 0, every row i of colour c takes
             x_i = (b_i - off_diagonal * sum_{j in N(i)} x_j) / diagonal,
             reading the x of this pass so far.  Rows of one colour read
             only rows of other colours when the colouring is proper, so
             a colour's rows update together;
  residual — ||b - A x||_2.

The arguments of `symgs` that depart from that (`round_to`, `backward`)
exist for the controls (kernels/symgs.py): the same formula a step below
what the configuration states, or half of it.
"""

from __future__ import annotations

import torch


def rhs(g, diagonal: float, off_diagonal: float) -> torch.Tensor:
    """float64[m] HPCG's b of the matrix on `g`: each row's sum."""
    return diagonal + off_diagonal * g.degrees.to(torch.float64)


def symgs(g, x0: torch.Tensor, b: torch.Tensor, colors: torch.Tensor, *,
          diagonal: float, off_diagonal: float, backward: bool = True,
          round_to=None) -> torch.Tensor:
    """float64[m]: x0 after one application under `colors` (int[m], each
    in [0, C)).  With `round_to` (a floating dtype) every product
    off_diagonal * x_j is rounded to it before the row's sum; without
    `backward` only the forward half runs."""
    dev = g.cols.device
    x = x0.to(device=dev, dtype=torch.float64).clone()
    b = b.to(device=dev, dtype=torch.float64)
    colors = colors.to(device=dev, dtype=torch.int64)
    num = int(colors.max()) + 1 if g.m else 0
    # the arcs and the rows of each colour, as contiguous runs
    arc_colors = colors[g.rows]
    arcs = torch.argsort(arc_colors, stable=True)
    arc_ends = torch.cumsum(torch.bincount(arc_colors, minlength=num),
                            0).tolist()
    rows = torch.argsort(colors, stable=True)
    row_ends = torch.cumsum(torch.bincount(colors, minlength=num),
                            0).tolist()
    passes = list(range(num))
    if backward:
        passes += passes[::-1]
    for c in passes:
        a = arcs[(arc_ends[c - 1] if c else 0):arc_ends[c]]
        r = rows[(row_ends[c - 1] if c else 0):row_ends[c]]
        prod = off_diagonal * x[g.cols[a]]
        if round_to is not None:
            prod = prod.to(round_to).to(torch.float64)
        sums = torch.zeros_like(x).index_add_(0, g.rows[a], prod)
        x[r] = (b[r] - sums[r]) / diagonal
    return x


def residual(g, x: torch.Tensor, b: torch.Tensor, *, diagonal: float,
             off_diagonal: float) -> float:
    """||b - A x||_2 in float64."""
    x = x.to(device=g.cols.device, dtype=torch.float64)
    ax = diagonal * x + torch.zeros_like(x).index_add_(
        0, g.rows, off_diagonal * x[g.cols])
    return float(torch.linalg.vector_norm(b.to(x) - ax))
