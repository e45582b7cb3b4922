"""Aggregate FSM for patterns of <= 2 edges — embedding-free MNI support;
torch counterpart of gardenia_tpu/mining/fsm_agg.py.

Reference behaviour: mining/fsm/fsm.h:23 (FSMSolver(k, minsup)) counts
frequent connected edge-patterns; the reference (and the gSpan engine,
mining/gspan.py) materializes every embedding to aggregate MNI domains,
which caps it at small graphs.

For 1- and 2-edge patterns the minimum-image support is a closed-form
aggregate over per-vertex LABEL-COUNT vectors — no embedding is ever
materialized.  Let C[v, l] = |{w in N(v): label(w) = l}|:

  edge (la, lb):   dom_a = #{v: lab v = la, C[v, lb] >= 1}  (dom_b sym.)
                   support = min(dom_a, dom_b); la == lb merges the two
                   automorphic positions into one identical domain.
  wedge (la -b- lc), la <= lc, center label lb:
    center domain: lab v = lb and (la != lc ? C[v,la] >= 1 and
                   C[v,lc] >= 1 : C[v,la] >= 2)  (endpoints distinct)
    endpoint-a domain: lab u = la and some neighbour v has lab lb and
                   C[v, lc] >= 1 + (la == lc)    (u itself is counted in
                   C[v, lc] exactly when la == lc, so demand one more)
    support = min over automorphism orbits (la == lc merges endpoints).

On the card that is 3 batched applies of the degree-relabelled forward
hybrid layout (views.relabeled_hybrid(reverse=False), threshold 16, the
layout BC's backward pass and the SpMV bench already build) through
ops/bsr.spmv_hybrid_batched: kernel K1's tensor-core route on the panels
with a bf16 0/1 operand (the one-hot label matrix, L columns; then the
B1/B2 lane matrices, L*L columns in chunks of MAX_LANES) and the batched
remainder.  The operands are 0/1, so bf16 holds them exactly, and K1 and
the remainder sum in f32, so the thresholds >= 0.5 / >= 1.5 are exact;
an f32 operand (and with it K1's split kernel) never appears.  Each
segment sum by label is an int64 index_add_.  The frequent-pattern count
equals gSpan's (MNI is anti-monotone, so every frequent wedge's
sub-edges are frequent — no pruning difference).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.mining.labels import default_labels

# lane budget for one batched pass: (lb, lc) column pairs are processed
# in chunks of <= MAX_LANES so any label-set size L works
MAX_LANES = 512


def label_ids(g, labels: Optional[np.ndarray] = None):
    """(lab int64[m] in 0..L-1, L): g's labels (labels.default_labels) as
    dense ids."""
    _, lab = np.unique(default_labels(g, labels), return_inverse=True)
    lab = lab.reshape(-1).astype(np.int64)
    return lab, int(lab.max()) + 1


def lane_chunks(L: int) -> list:
    """The (lb, lc) column pairs of the L*L lanes, in chunks of <=
    MAX_LANES: [(plb int64, plc int64), ...]."""
    pair_lb, pair_lc = np.divmod(np.arange(L * L, dtype=np.int64), L)
    return [(pair_lb[i:i + MAX_LANES], pair_lc[i:i + MAX_LANES])
            for i in range(0, L * L, MAX_LANES)]


def aggregates(apply: Callable, lab_d: torch.Tensor, L: int):
    """(G1, G2, Dcnt, D2, edge_dom), int64 numpy: the label aggregates of
    the graph whose adjacency product is apply(x2d) -> (m, S) f32, with
    the vertices' label ids lab_d (int64[m], on apply's device).
    G1, G2, Dcnt: (L, L*L); D2, edge_dom: (L, L)."""
    dev = lab_d.device

    def by_label(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((L, x.shape[1]), dtype=torch.int64, device=dev)
        return out.index_add_(0, lab_d, x.long())

    onehot = lab_d[:, None] == torch.arange(L, device=dev)[None, :]
    C = apply(onehot.to(torch.bfloat16))
    E1 = C >= 0.5
    E2 = C >= 1.5
    del C
    G1s, G2s, Ds = [], [], []
    for plb, plc in lane_chunks(L):
        plb = torch.from_numpy(plb).to(dev)
        plc = torch.from_numpy(plc).to(dev)
        sel = onehot[:, plb]
        G1s.append(by_label(apply((sel & E1[:, plc]).to(torch.bfloat16))
                            >= 0.5))
        G2s.append(by_label(apply((sel & E2[:, plc]).to(torch.bfloat16))
                            >= 0.5))
        # centre pair-AND counts per label: [lb, (la, lc)]
        Ds.append(by_label(E1[:, plb] & E1[:, plc]))
    out = (torch.cat(G1s, dim=1), torch.cat(G2s, dim=1), torch.cat(Ds, dim=1),
           by_label(E2), by_label(E1))
    return tuple(t.cpu().numpy() for t in out)


def hybrid_apply(g, device):
    """(apply, old_of_new): x2d -> A x2d over the degree-relabelled forward
    hybrid layout of g, and the map that takes g's labels to the
    relabelled ids (lab[old_of_new])."""
    from gardenia_tpu_torch.core import views
    from gardenia_tpu_torch.ops.bsr import spmv_hybrid_batched
    g2, hyb, _ = views.relabeled_hybrid(g, device, reverse=False)
    _, _, old_of_new = views.relabel_maps(g, device)

    def apply(x2d):
        return spmv_hybrid_batched(hyb, x2d, num_rows=g2.m)
    return apply, old_of_new


def fsm_aggregates(g, labels: Optional[np.ndarray] = None, device="cuda"):
    """(aggregates(...) over g's hybrid layout, L)."""
    dev = resolve_device(device)
    lab, L = label_ids(g, labels)
    apply, old_of_new = hybrid_apply(g, dev)
    lab_d = torch.from_numpy(lab).to(dev)[old_of_new]
    return aggregates(apply, lab_d, L), L


def fsm_k2_aggregate(g, k: int, minsup: int,
                     labels: Optional[np.ndarray] = None,
                     device="cuda") -> int:
    """Cumulative frequent-pattern count for k in {1, 2} (the same
    convention as mining/gspan.fsm_gspan).  g must be symmetric."""
    if k < 1 or g.m == 0 or g.nnz == 0:
        return 0
    if k > 2:
        raise ValueError("fsm_k2_aggregate handles k <= 2 only")
    (G1, G2, Dcnt, D2, edge_dom), L = fsm_aggregates(g, labels, device)

    total = 0
    for la in range(L):
        for lb in range(la, L):
            sup = (edge_dom[la, la] if la == lb
                   else min(edge_dom[la, lb], edge_dom[lb, la]))
            if sup >= minsup:
                total += 1
    if k == 1:
        return total
    for lb in range(L):                 # center label
        for la in range(L):
            for lc in range(la, L):     # endpoint labels, la <= lc
                if la == lc:
                    center = D2[lb, la]
                    dom_a = G2[la, lb * L + lc]
                    sup = min(center, dom_a)
                else:
                    center = Dcnt[lb, la * L + lc]
                    dom_a = G1[la, lb * L + lc]
                    dom_c = G1[lc, lb * L + la]
                    sup = min(center, dom_a, dom_c)
                if sup >= minsup:
                    total += 1
    return total
