"""Clustering — single-linkage clustering at a weight threshold; torch
counterpart of gardenia_tpu/solvers/clustering.py (the reference's
src/clustering is an empty skeleton).

One dendrogram level: the connected components of the graph after the
edges below the threshold are removed (all edges are kept when the graph
is unweighted), by min-label hooking and pointer jumping to a fixed
point.  Labels are the least vertex id of each cluster, as the JAX
solver's.  The jumping runs ceil(log2 m) steps, enough to compress any
forest whose labels only decrease, so a round reads once: whether a label
changed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import views
from gardenia_tpu_torch.ops.pointer_jump import pointer_jump_n


@dataclasses.dataclass
class ClusterResult:
    labels: torch.Tensor     # i32[m]: cluster representative ids
    num_clusters: int


def cluster_threshold(g, threshold: float = 0.0, *,
                      device="cuda") -> ClusterResult:
    """Merge the endpoints of every edge of weight >= threshold (every
    edge when g is unweighted)."""
    dev = resolve_device(device)
    m = g.m
    src, dst = (t.long() for t in views.coo(g, dev))
    keep = (torch.ones_like(src, dtype=torch.bool) if g.weights is None
            else views.edge_weights(g, dev) >= np.float32(threshold))
    steps = max(1, int(np.ceil(np.log2(max(m, 2)))))
    comp = torch.arange(m, dtype=torch.int32, device=dev)
    while True:
        ls, ld = comp[src], comp[dst]
        new = torch.cat([comp, comp.new_zeros(1)])    # a pad slot, dropped
        new.scatter_reduce_(0, torch.where(keep, ld, m).long(), ls, "amin")
        new.scatter_reduce_(0, torch.where(keep, ls, m).long(), ld, "amin")
        new = pointer_jump_n(new[:m], steps)
        if not bool((new != comp).any()):
            return ClusterResult(new, len(torch.unique(new)))
        comp = new
