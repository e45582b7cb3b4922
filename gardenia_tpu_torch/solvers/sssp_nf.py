"""SSSP — near-far delta-stepping on compact queues; torch counterpart of
gardenia_tpu/solvers/sssp_nf.py (reference src/sssp/dstep.cu:86-122).

State: dist[m], the near queue q (qn ids), the far queue fq (fn ids), the
threshold and an overflow flag.  A round is one of:
  * NEAR (qn > 0): expand the near queue's out-edges, scatter-min into
    dist; an edge that won its target (nd == the new dist[dst], and it
    improved) pushes dst into the near queue when nd < thresh, else
    appends it to the far queue.
  * BURST (the near queue's out-edges exceed the edge capacity): drop the
    queue and flag an overflow.
  * ADVANCE (qn == 0): move the threshold to the lowest occupied far
    bucket and re-split the far queue (dstep.cu:122).
  * DENSE REBUILD (overflow): one relax-all Bellman-Ford sweep, which
    subsumes every queued obligation, and both queues rebuilt from the
    improved vertices.
The capacities Q (near), F = 4 Q (far) and cap_e (edges) are the JAX
package's (`_default_caps`, `q_cap`): they decide where a round
overflows or bursts, so `iterations` match the JAX solver's.

The JAX solver runs its rounds under lax.while_loop with one lax.switch
over graduated static capacity tiers, which only give XLA static shapes.
Here the loop runs on the host, and every round ends with one packed read
of the counts it produced (the near pushes, the far pushes and the new
near queue's out-edges, the scout), from which the host derives qn, fn
and the overflow flag and chooses the next branch; the queues then hold
exactly their entries and a relax expands exactly their edges.  The TPU
row tables (rowsel.to_rows, expand_frontier_edges_tbl) and the host
segmentation are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.ops.frontier import compact_mask
from gardenia_tpu_torch.solvers.sssp import (INF, Relaxer, SSSPResult,
                                             _start)


def _default_caps(m: int, nnz: int):
    """(Q, F, cap_e): near-queue capacity ~ the frontier band of a
    high-diameter graph (O(sqrt(m)) on grids); edge capacity covers it at
    the graph's mean degree with 2x slack (gardenia_tpu/solvers/
    sssp_nf.py:53-63)."""
    q = T.next_pow2(int(np.clip(4 * int(np.sqrt(max(m, 1))), 1024, 65536)))
    return q, 4 * q, _edge_cap(q, m, nnz)


def _edge_cap(q: int, m: int, nnz: int) -> int:
    mean_deg = max(4, -(-2 * nnz // max(m, 1)))
    return T.next_pow2(max(256, min(q * mean_deg, max(nnz, 256))))


def sssp_nearfar(g, source: int = 0, delta: int = 1, *, q_cap: int = None,
                 max_rounds: int = None, device="cuda") -> SSSPResult:
    """Near-far delta-stepping (dstep.cu): exact, the same fixed point as
    Bellman-Ford.  `q_cap` sets the near queue's capacity (None: the
    sqrt(m) heuristic); a small one forces the overflow path."""
    dev = resolve_device(device)
    m = g.m
    delta = max(1, int(delta))
    Q, F, cap_e = _default_caps(m, g.nnz)
    if q_cap:
        Q = T.next_pow2(int(q_cap))
        F = 4 * Q
        cap_e = _edge_cap(Q, m, g.nnz)
    if max_rounds is None:
        max_rounds = 4 * m + 16
    # the widest of the JAX solver's capacity tiers: a round bursts when
    # its queue or its out-edges exceed it (gardenia_tpu/solvers/
    # sssp_nf.py:116-121, 214-229)
    q_max, e_max = max(256, Q), max(512, cap_e)

    r = Relaxer.of(g, dev)
    dist, _ = _start(m, source, dev)
    q = torch.full((1,), source, dtype=torch.int32, device=dev)
    fq = torch.empty(0, dtype=torch.int32, device=dev)
    thresh = torch.tensor(delta, dtype=torch.int32, device=dev)
    qn, fn, ovf, scout = 1, 0, False, int(g.degrees[source])
    it = 0

    def read(*counts):
        return (int(v) for v in torch.stack(counts).tolist())

    while (qn > 0 or fn > 0 or ovf) and it < max_rounds:
        it += 1
        if ovf:                                   # DENSE REBUILD
            new = r.dense(dist)
            improved = new < dist
            dist = new
            nm = torch.where(improved, dist, INF).min() // delta
            thresh = torch.where(improved.any(),
                                 torch.maximum(thresh, nm * delta + delta),
                                 thresh)
            near = improved & (dist < thresh)
            far = improved & ~near
            ncount, fcount, scout = read(
                near.sum(), far.sum(), torch.where(near, r.deg, 0).sum())
            q = compact_mask(near, min(ncount, Q), m)
            fq = compact_mask(far, min(fcount, F), m)
            ovf = ncount > Q or fcount > F
            qn = 0 if ncount > Q else ncount
            fn = min(fcount, F)
        elif qn == 0:                             # ADVANCE
            dv = dist[fq.long()]
            nm = (dv // delta).min()
            # max() keeps the threshold monotone: stale far entries
            # (settled below it via another path) migrate into one
            # harmless near round instead of stepping it back
            thresh = torch.maximum(thresh, nm * delta + delta)
            near = dv < thresh
            ncount, fcount, scout = read(
                near.sum(), (~near).sum(),
                torch.where(near, r.deg[fq.long()], 0).sum())
            q = fq[compact_mask(near, min(ncount, Q), 0).long()]
            fq = fq[compact_mask(~near, fcount, 0).long()]
            ovf = ncount > Q
            qn = 0 if ovf else ncount
            fn = fcount
        elif qn > q_max or scout > e_max:         # BURST
            q = q[:0]
            qn, ovf = 0, True
        else:                                     # NEAR
            if scout == 0:
                q, qn = q[:0], 0
                continue
            dst, nd = r.edges(dist, q, scout)
            dl = dst.long()
            new = dist.scatter_reduce(0, dl, nd, "amin")
            new_at = new[dl]
            winner = (new_at < dist[dl]) & (nd == new_at)
            dist = new
            near = winner & (nd < thresh)
            far = winner & ~near
            ncount, fcount, scout = read(
                near.sum(), far.sum(), torch.where(near, r.deg[dl], 0).sum())
            q = dst[compact_mask(near, min(ncount, Q), 0).long()]
            fq = torch.cat([fq, dst[compact_mask(far, fcount, 0).long()]])
            ovf = ncount > Q or fn + fcount > F
            qn = 0 if ncount > Q else ncount
            fq = fq[:F]         # pushes past the capacity are dropped
            fn = min(fn + fcount, F)
    return SSSPResult(dist, it)
