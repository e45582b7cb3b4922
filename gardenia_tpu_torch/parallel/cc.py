"""Multi-device connected components: a 1D vertex partition, min-label
hooking and pointer jumping — the torch counterpart of
gardenia_tpu/parallel/cc.py.

Each rank owns a contiguous vertex range and its adjacency; labels are
PADDED-GLOBAL vertex ids (parallel/partition), one per owned slot, and
the padded coordinate is monotone in the vertex id, so the least label
is the least id.  A round, on every rank:
  comp_full = all_gather(comp_l)
  hook:      comp_l' = min(comp_l, min over the rank's rows of comp_full)
  shortcut:  comp_l' = min(comp_l', comp_full[comp_l']), _JUMPS times
  alive     = all_reduce(|comp_l' != comp_l|)     (the round's one read)
the scale-out form of the reference's hooking and compression
(src/cc/omp_afforest.cc:37-83).  Pad slots label themselves and have no
edges, so they never propagate.

layout='hybrid' (the default) hooks through ops/bsr.spmv_hybrid_min_select
on the rank's shard of the degree-relabelled graph: kernel K2 on its
dense panels every round, the ELL remainder beside it; the final pass
renames each component to its least ORIGINAL id.  layout='ell' hooks over
ELL slabs of the original ids.  g must be symmetric, as the reference's
CC takes it.
"""

from __future__ import annotations

import torch

from gardenia_tpu_torch.parallel.pr import shard_of
from gardenia_tpu_torch.solvers.cc import CCResult

_JUMPS = 4   # pointer-jump gathers a round on the gathered label table


def cc_solver_dist(g, *, mesh, balance: str = "edges",
                   max_rounds: int = None,
                   layout: str = "hybrid") -> CCResult:
    """Distributed CC of symmetric g on every rank of mesh: each vertex's
    label is the least original id of its component (original order), on
    every rank."""
    from gardenia_tpu_torch.ops.bsr import spmv_hybrid_min_select
    from gardenia_tpu_torch.ops.semiring import I32_MIN_SELECT2
    from gardenia_tpu_torch.ops.spmv import spmv_ell
    if layout not in ("hybrid", "ell"):
        raise ValueError(f"unknown CC layout {layout!r}")
    if max_rounds is None:
        max_rounds = g.m + 1
    dev = mesh.device
    rel = None
    if layout == "hybrid":
        from gardenia_tpu_torch.core.relabel import relabeled
        rel = relabeled(g)
    g2 = g if rel is None else rel.graph
    sh = shard_of(g2, mesh, layout, balance, reverse=False)
    mb = sh.ranges.rows_per_shard
    pad_n = sh.ranges.padded_size()
    # every slot starts with its own padded id, pad slots included
    comp = torch.arange(mesh.rank * mb, (mesh.rank + 1) * mb,
                        dtype=torch.int32, device=dev)
    it, alive = 0, 1
    while alive > 0 and it < max_rounds:
        full = mesh.all_gather(comp)
        if layout == "hybrid":
            cand = spmv_hybrid_min_select(sh.mat, full, num_rows=mb,
                                          sentinel=pad_n)
        else:
            cand = spmv_ell(sh.mat, full, semiring=I32_MIN_SELECT2,
                            num_rows=mb)
        new = torch.minimum(comp, cand)
        for _ in range(_JUMPS):
            new = torch.minimum(new, full[new.long()])
        alive = int(mesh.all_reduce((new != comp).sum(dtype=torch.int32)))
        comp = new
        it += 1
    # padded label -> (relabelled) vertex id, per (relabelled) vertex
    r = sh.ranges
    vid_of_padded = torch.from_numpy(r.to_padded(
        torch.arange(g2.m, dtype=torch.int32).numpy(), 0)).to(dev)
    labels = vid_of_padded[r.from_padded(mesh.all_gather(comp)).long()]
    if rel is None:
        return CCResult(labels, it)
    new_of_old = torch.from_numpy(rel.new_of_old).to(dev).long()
    old_of_new = torch.from_numpy(rel.old_of_new).to(dev).long()
    comp = old_of_new[labels.long()[new_of_old]]
    # each component renamed to its least original id
    least = torch.full((g.m,), g.m, dtype=torch.int64, device=dev)
    least.scatter_reduce_(0, comp, torch.arange(g.m, device=dev), "amin")
    return CCResult(least[comp].to(torch.int32), it)
