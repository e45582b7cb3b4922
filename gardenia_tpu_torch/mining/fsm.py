"""FSM — frequent subgraph mining on labelled graphs (MNI domain support);
torch counterpart of gardenia_tpu/mining/fsm.py.

Reference: mining/fsm/{fsm.h,serial.cc,omp_base.cc} and
mining/fsm2/miner.h (Pangolin edge miner: BFS embedding expansion,
quick-pattern aggregation, canonical-pattern domain support, filter,
repeat up to k edges; canonical forms via bliss +
include/dfscode/dfs_code.hpp).

k <= 2 takes the embedding-free aggregate (mining/fsm_agg.py: 3 batched
hybrid applies, kernel K1 on the panels), any larger k the gSpan engine
(mining/gspan.py: host canonical forms, device expansion).  Support is
minimum-image (MNI) closed under vertex-position automorphism
equivalence — the same convention as the reference's equivalence-set
union (edge_miner.h:175-193).

Counts the number of frequent patterns with 1..k edges (cumulative),
any k.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gardenia_tpu_torch.utils.profiler import spanned


@spanned("solve.fsm")
def fsm_solver(g, k: int = 2, minsup: int = 2,
               labels: Optional[np.ndarray] = None, device="cuda") -> int:
    """Reference entry FSMSolver(m, nnz, k, minsup, row_offsets,
    column_indices, labels, total) (mining/fsm/fsm.h:23).  g symmetric;
    labels default to g.vlabels, else degree-bucket synthetic labels
    (deterministic), matching the converter's labelling fallback."""
    if k < 1:
        return 0
    if k <= 2:
        from gardenia_tpu_torch.mining.fsm_agg import fsm_k2_aggregate
        return fsm_k2_aggregate(g, k, minsup, labels, device=device)
    from gardenia_tpu_torch.mining.gspan import fsm_gspan
    return fsm_gspan(g, k, minsup, labels, device=device)


def fsm_verifier(g, k: int = 2, minsup: int = 2,
                 labels: Optional[np.ndarray] = None) -> int:
    """Brute-force oracle: enumerate every connected edge-subgraph with
    <= k edges by recursive edge addition, aggregate true MNI domains
    per canonical pattern (independent of the device engine)."""
    from gardenia_tpu_torch.mining.gspan import fsm_bruteforce
    return fsm_bruteforce(g, k, minsup, labels)
