"""Multi-device SpMV: a 1D row partition — the torch counterpart of
gardenia_tpu/parallel/spmv.py.

Each rank owns a contiguous row range and the weighted edges into it; the
operand is all-gathered and the rank's product writes only its own rows,
the scale-out form of the reference's row-parallel SpMV
(src/spmv/omp_base.cc:12-41).

layout='hybrid' (the default, square matrices) sweeps the rank's weighted
shard of the degree-relabelled matrix through ops/bsr.spmv_hybrid: kernel
K1 on its dense panels at S = 1 with an f32 operand, the ELL remainder
beside it.  A rectangular matrix, or layout='ell', takes weighted ELL
slabs over the original ids.
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu_torch.parallel import partition


def _padded(sh, values: np.ndarray, fill: float) -> torch.Tensor:
    """The rank's rows of a per-row f32 array, padded to rows_per_shard
    with `fill`."""
    out = np.full(sh.ranges.rows_per_shard, fill, np.float32)
    out[:sh.hi - sh.lo] = values[sh.lo:sh.hi]
    return torch.from_numpy(out)


def spmv_solver_dist(g, Ax=None, x=None, y=None, *, mesh,
                     balance: str = "edges", layout: str = "hybrid"):
    """Distributed y + A x on every rank of mesh, f32, in original row
    order on the rank's device.  Ax defaults as the single-device solver
    does (the graph's weights, else the reference's synthetic 0.2,
    src/spmv/main.cc:28-37), x to 0.3, y to 0."""
    from gardenia_tpu_torch.ops.bsr import spmv_hybrid
    from gardenia_tpu_torch.ops.semiring import F32_PLUS_TIMES
    from gardenia_tpu_torch.ops.spmv import spmv_ell
    if layout not in ("hybrid", "ell"):
        raise ValueError(f"unknown SpMV layout {layout!r}")
    if Ax is None:      # one default array a graph, so its shard is reused
        Ax = g._dev(("spmv_default_values",), lambda: (
            np.full(g.nnz, 0.2, np.float32) if g.weights is None
            else np.asarray(g.weights, np.float32)))
    if x is None:
        x = np.full(g.n, 0.3, np.float32)
    x = np.asarray(x, np.float32)
    y0 = np.zeros(g.m, np.float32) if y is None else np.asarray(y, np.float32)
    dev = mesh.device
    hybrid = layout == "hybrid" and g.n == g.m
    old_of_new = new_of_old = None

    def build():
        if not hybrid:
            return None, partition.ell_shard(
                g, mesh.size, mesh.rank, ax=Ax, balance=balance)
        from gardenia_tpu_torch.core.graph import Graph
        from gardenia_tpu_torch.core.relabel import degree_relabel
        # Ax (forward CSR order) rides the relabelling as the weights
        rel = degree_relabel(Graph(g.rowptr, g.colidx,
                                   np.asarray(Ax, np.float32),
                                   num_cols=g.n, symmetric=g.symmetric))
        return rel, partition.hybrid_shard(
            rel.graph, mesh.size, mesh.rank, weighted=True, balance=balance)

    def mk():
        rel, sh = build()
        sh.mat = sh.mat.to(dev)
        return rel, sh
    rel, sh = g._dev(("torch", "spmv_shard", hybrid, balance, mesh.size,
                      mesh.rank, str(dev), id(Ax)), mk, retain=Ax)
    mb = sh.ranges.rows_per_shard
    if rel is not None:
        old_of_new = np.asarray(rel.old_of_new, np.int64)
        new_of_old = np.asarray(rel.new_of_old, np.int64)
        x, y0 = x[old_of_new], y0[old_of_new]
    x_l = _padded(sh, x, 0.0).to(dev)
    y_l = _padded(sh, y0, 0.0).to(dev)
    x_full = mesh.all_gather(x_l)
    if hybrid:
        out = spmv_hybrid(sh.mat, x_full, num_rows=mb, init=y_l)
    else:
        out = spmv_ell(sh.mat, x_full, semiring=F32_PLUS_TIMES, num_rows=mb,
                       init=y_l)
    full = sh.ranges.from_padded(mesh.all_gather(out))
    if new_of_old is not None:
        full = full[torch.from_numpy(new_of_old).to(dev)]
    return full
