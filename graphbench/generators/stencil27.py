"""HPCG's 27-point stencil (reference GenerateProblem_ref.cpp): the rows of
an nx x ny x nz grid, row ix + nx * (iy + ny * iz), each joined to the
grid points within one step in every axis.  The structure is fixed: the
torch.Generator is not read, so every seed gives the same edges and
nothing is permuted (HPCG's own numbering).

The dims come from `scale` alone: powers of two nx >= ny >= nz whose
exponents differ by at most one and sum to scale (20: 128 x 128 x 64;
10: 16 x 8 x 8).  Each row emits its 13 forward neighbours (the offsets
whose first non-zero component, from z down to x, is +1); the consumer's
symmetrize adds the other 13."""

from __future__ import annotations

import torch

FORWARD = [(dx, dy, dz)
           for dz in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
           if (dz, dy, dx) > (0, 0, 0)]


def dims(scale: int) -> tuple:
    """(nx, ny, nz) of 2^scale rows."""
    low, extra = divmod(int(scale), 3)
    return (1 << (low + (extra > 0)), 1 << (low + (extra > 1)), 1 << low)


def edges(cfg: dict, gen: torch.Generator, device):
    nx, ny, nz = dims(cfg["scale"])
    ids = torch.arange(nx * ny * nz, dtype=torch.int64, device=device)
    ix, iy, iz = ids % nx, ids // nx % ny, ids // (nx * ny)
    src, dst = [], []
    for dx, dy, dz in FORWARD:
        inside = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                  & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
        rows = ids[inside]
        src.append(rows)
        dst.append(rows + dx + nx * (dy + ny * dz))
    return torch.cat(src).to(torch.int32), torch.cat(dst).to(torch.int32)
