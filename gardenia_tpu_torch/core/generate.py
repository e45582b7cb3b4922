"""Synthetic graph generators — counterpart of the reference's GAP port
(include/generator.h:33-116: uniform and R-MAT Graph500 generators, used
via CLI '-g'/'-u' scale flags in include/command_line.h).

Vectorized NumPy; R-MAT uses the Graph500 (A,B,C,D)=(.57,.19,.19,.05)
partition probabilities like generator.h:116.
"""

from __future__ import annotations

import numpy as np

from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.core.graph import Graph, from_edges
from gardenia_tpu_torch.core.io import EdgeListData


def uniform_edges(scale: int, degree: int = 16, seed: int = 27491095
                  ) -> EdgeListData:
    """2^scale vertices, degree*2^scale uniform random edges
    (generator.h:33 MakeUniformEL, kRandSeed generator.h:22)."""
    m = 1 << scale
    nnz = m * degree
    rng = np.random.default_rng(seed)
    src = rng.integers(0, m, nnz).astype(T.VID_DTYPE)
    dst = rng.integers(0, m, nnz).astype(T.VID_DTYPE)
    return EdgeListData(m, m, src, dst, None)


def rmat_edges(scale: int, degree: int = 16, seed: int = 27491095,
               a: float = 0.57, b: float = 0.19, c: float = 0.19
               ) -> EdgeListData:
    """R-MAT/Kronecker edges, Graph500 probabilities (generator.h:116)."""
    m = 1 << scale
    nnz = m * degree
    rng = np.random.default_rng(seed)
    src = np.zeros(nnz, np.int64)
    dst = np.zeros(nnz, np.int64)
    for bit in range(scale):
        r = rng.random(nnz)
        # quadrant choice: P(src_bit, dst_bit)
        src_bit = r > a + b                      # quadrants c or d
        dst_bit = (r > a) & (r <= a + b) | (r > a + b + c)  # b or d
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    # permute vertex ids to break degree-locality correlation
    perm = rng.permutation(m)
    return EdgeListData(m, m, perm[src].astype(T.VID_DTYPE),
                        perm[dst].astype(T.VID_DTYPE), None)


def grid_edges(side: int, seed: int = 0, max_weight: int = 256
               ) -> EdgeListData:
    """side x side 4-neighbor grid — a road-network-like high-diameter
    fixture (diameter ~ 2*side), with random integer weights.  Stands in
    for road_usa/road_central (BASELINE.md eval datasets) in tests."""
    m = side * side
    ids = np.arange(m, dtype=np.int64).reshape(side, side)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()])
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()])
    e = np.concatenate([right, down], axis=1)
    rng = np.random.default_rng(seed)
    wt = rng.integers(1, max_weight, e.shape[1]).astype(np.float64)
    return EdgeListData(m, m, e[0].astype(T.VID_DTYPE),
                        e[1].astype(T.VID_DTYPE), wt)


def generate_graph(kind: str = "rmat", scale: int = 16, degree: int = 16,
                   seed: int = 27491095, symmetrize: bool = True,
                   need_reverse: bool = False, weighted: bool = False
                   ) -> Graph:
    """Build a cleaned synthetic Graph (self-loops/dups removed)."""
    e = (rmat_edges if kind == "rmat" else uniform_edges)(
        scale, degree, seed)
    if weighted:
        rng = np.random.default_rng(seed + 1)
        e.wt = rng.integers(1, 256, len(e.src)).astype(np.float64)
    return from_edges(e, symmetrize=symmetrize, need_reverse=need_reverse)
