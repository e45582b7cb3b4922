"""Graph500 Kronecker (R-MAT), a frozen torch copy of the port's
core/generate.rmat_edges rule: every edge picks one quadrant a bit,
P = (a, b, c, 1 - a - b - c); then one random permutation of the vertex
ids, so degree does not follow the id.  Keys: scale, edge_factor, a, b,
c."""

from __future__ import annotations

import torch


def quadrants(scale: int, nnz: int, a: float, b: float, c: float,
              gen: torch.Generator, device):
    """(src, dst) int64 of `nnz` R-MAT edges before the permutation."""
    src = torch.zeros(nnz, dtype=torch.int64, device=device)
    dst = torch.zeros(nnz, dtype=torch.int64, device=device)
    for bit in range(scale):
        r = torch.rand(nnz, generator=gen, device=device)
        # quadrant: c or d sets the source bit, b or d the destination bit
        src |= (r > a + b).to(torch.int64) << bit
        dst |= (((r > a) & (r <= a + b)) | (r > a + b + c)).to(
            torch.int64) << bit
    return src, dst


def edges(cfg: dict, gen: torch.Generator, device):
    scale = int(cfg["scale"])
    m = 1 << scale
    src, dst = quadrants(scale, m * int(cfg["edge_factor"]),
                         float(cfg["a"]), float(cfg["b"]), float(cfg["c"]),
                         gen, device)
    perm = torch.randperm(m, generator=gen, device=device)
    return perm[src].to(torch.int32), perm[dst].to(torch.int32)
