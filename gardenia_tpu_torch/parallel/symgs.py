"""Multi-device SymGS: a 1D row partition, colour-masked sweeps over the
rank's weighted hybrid shard — the torch counterpart of
gardenia_tpu/parallel/symgs.py.

The reference sweeps the colour blocks forward, then backward
(src/symgs/omp_base.cc:7-41); rows of one colour are independent (a
proper colouring), so the rows are sharded and each colour is, on every
rank,
  x_full = all_gather(x_l)
  rsum   = the rank's rows of A x_full   (ops/bsr.spmv_hybrid: K1 at S = 1
                                          on the dense panels, the ELL
                                          remainder beside it)
  x_l[i] = (b - rsum) / diag  where colors[i] == c and diag != 0
— 2 x colours all-gathers an application.  Ax rides the relabelled
weighted panels.
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu_torch.parallel import partition
from gardenia_tpu_torch.parallel.spmv import _padded
from gardenia_tpu_torch.solvers.symgs import (SymGSResult, default_inputs,
                                              fill_inputs)


def symgs_solver_dist(g, Ax=None, x=None, b=None, diag=None, colors=None,
                      *, mesh, balance: str = "edges") -> SymGSResult:
    """Distributed SymGS application on every rank of mesh: x in original
    vertex order.  The missing inputs are filled as the single-device
    solver fills them (Ax, x, b from default_rng(13), diag = degree + 1,
    vc_solver's colours on the rank's device)."""
    from gardenia_tpu_torch.core.graph import Graph
    from gardenia_tpu_torch.core.relabel import degree_relabel
    from gardenia_tpu_torch.ops.bsr import spmv_hybrid
    dev = mesh.device
    if all(a is None for a in (Ax, x, b, diag, colors)):
        # the same arrays as fill_inputs', once a graph: the shard is reused
        Ax, x, b, diag, colors = default_inputs(g, dev)
    else:
        Ax, x, b, diag, colors = fill_inputs(g, Ax, x, b, diag, colors,
                                             device=dev)
    num_colors = int(np.max(colors)) + 1

    def mk():
        rel = degree_relabel(Graph(g.rowptr, g.colidx,
                                   np.asarray(Ax, np.float32),
                                   num_cols=g.n, symmetric=g.symmetric))
        sh = partition.hybrid_shard(rel.graph, mesh.size, mesh.rank,
                                    weighted=True, balance=balance)
        sh.mat = sh.mat.to(dev)
        return rel, sh
    rel, sh = g._dev(("torch", "symgs_shard", balance, mesh.size, mesh.rank,
                      str(dev), id(Ax)), mk, retain=Ax)
    mb = sh.ranges.rows_per_shard
    oon = np.asarray(rel.old_of_new, np.int64)
    colors_l = torch.from_numpy(np.full(mb, -1, np.int32))   # pads never
    colors_l[:sh.hi - sh.lo] = torch.from_numpy(               # update
        np.asarray(colors, np.int32)[oon][sh.lo:sh.hi])
    colors_l = colors_l.to(dev)
    diag_l = _padded(sh, np.asarray(diag, np.float32)[oon], 1.0).to(dev)
    b_l = _padded(sh, np.asarray(b, np.float32)[oon], 0.0).to(dev)
    x_l = _padded(sh, np.asarray(x, np.float32)[oon], 0.0).to(dev)
    live = diag_l != 0
    order = list(range(num_colors))
    for c in order + order[::-1]:                # forward, then backward
        rsum = spmv_hybrid(sh.mat, mesh.all_gather(x_l), num_rows=mb)
        x_l = torch.where((colors_l == c) & live, (b_l - rsum) / diag_l, x_l)
    x_rel = sh.ranges.from_padded(mesh.all_gather(x_l))
    return SymGSResult(
        x_rel[torch.from_numpy(np.asarray(rel.new_of_old, np.int64)).to(dev)],
        num_colors)
