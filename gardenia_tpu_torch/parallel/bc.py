"""Multi-device betweenness centrality: the source batch sharded, the
graph replicated — the torch counterpart of gardenia_tpu/parallel/bc.py.

Brandes' accumulations from distinct sources are independent, so each
rank runs the batched forward and backward passes of solvers/bc.py on its
S/n sources with no traffic between ranks, and the per-vertex dependency
sums are all-reduced at the end (with the deepest rank's level count):
the reference's sequential per-source loop (src/bc/omp_base.cc:69)
spread over the ranks, as parallel/bfs.py's data-parallel MS-BFS is.
layout='hybrid' pulls through ops/bsr.spmv_hybrid_batched on the
degree-relabelled graph (K1's tensor-core kernel at S/n columns, an f32
operand split into three bf16 terms); 'coo' (the JAX package's name) or
'ell' takes the per-edge path; 'auto' resolves as the port's bc_batched
does: hybrid.
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.solvers.bc import (BCResult, _normalized,
                                           batched_sums)

INF = np.int32(T.MYINFINITY)


def bc_batched_dist(g, sources, *, mesh, layout: str = "auto") -> BCResult:
    """Distributed batched Brandes on every rank of mesh: the scores over
    all sources, normalized by the max, in original vertex order, and the
    forward levels of the deepest rank.  The mesh size must divide S."""
    sources = np.asarray(sources, np.int64)
    S, n = len(sources), mesh.size
    if S % n:
        raise ValueError(f"the mesh size ({n}) must divide the source "
                         f"count ({S})")
    per = S // n
    mine = sources[mesh.rank * per:(mesh.rank + 1) * per]
    scores, levels = batched_sums(g, mine, layout={"coo": "ell"}.get(
        layout, layout), dev=mesh.device)
    scores = mesh.all_reduce(scores)
    levels = int(mesh.all_reduce(torch.tensor(
        levels, dtype=torch.int32, device=mesh.device), "max"))
    return BCResult(_normalized(scores), levels)
