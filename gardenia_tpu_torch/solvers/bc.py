"""BC — betweenness centrality (Brandes); torch counterpart of
gardenia_tpu/solvers/bc.py (reference src/bc/{bc.h,omp_base.cc}: a forward
BFS records depths and path counts sigma, a backward pass accumulates the
dependencies delta level by level, scores are normalized by the max).

Both passes are dense level-synchronous plus-times SpMVs; "successor" is
read off the depth array (succ(u, v) <=> depth[v] == depth[u] + 1):
  forward  d: paths = A_in @ (sigma where depth == d); rows with paths > 0
              that are undiscovered get depth d + 1 and sigma = paths
  backward d: delta[u] = sigma[u] * sum over out-neighbours v at depth
              d + 1 of (1 + delta[v]) / sigma[v], for rows at depth d.
The JAX solver runs both loops under lax.while_loop; here they run on the
host, with one read per forward level (whether a vertex was discovered)
and none in the backward pass, whose length the forward pass fixed.

`bc_batched` runs S sources at once, state (m, S).  Layouts:
  'hybrid' — the degree-relabelled hybrid layout, both directions through
             ops/bsr.spmv_hybrid_batched (K1 on tensor cores) with an f32
             operand: sigma path counts and delta ratios need f32-faithful
             products.
  'ell'    — the per-edge path over sorted COO edges (ops/spmv.
             spmv_batched), no panels.
  'auto'   — hybrid.
`bc_solver` is the single-source solver over the ELL layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.core import views
from gardenia_tpu_torch.ops.semiring import F32_PLUS_TIMES, I32_PLUS_TIMES
from gardenia_tpu_torch.ops.spmv import spmv_ell
from gardenia_tpu_torch.utils.profiler import spanned

INF = int(T.MYINFINITY)


@dataclasses.dataclass
class BCResult:
    scores: torch.Tensor   # f32[m], normalized by the max
    iterations: int        # forward levels


def _brandes(pull_in, pull_out, depth: torch.Tensor, sigma: torch.Tensor,
             discover=None):
    """(delta, forward levels) of Brandes' two passes on a state of any
    trailing shape.  `discover(frontier mask)`, when given, marks the rows
    a level reaches (the single-source solver counts in-neighbours in
    int32); otherwise a row is reached iff paths > 0.5: sigma on the
    frontier is >= 1, so paths > 0 iff an in-neighbour is on the level."""
    d = 0
    alive = True
    while alive:
        on_level = depth == d
        paths = pull_in(torch.where(on_level, sigma, 0.0))
        reached = paths > 0.5 if discover is None else discover(on_level) > 0
        newly = reached & (depth == INF)
        depth = torch.where(newly, d + 1, depth)
        sigma = torch.where(newly, paths, sigma)
        d += 1
        alive = bool(newly.any())           # the level's one read
    delta = torch.zeros_like(sigma)
    # from the deepest level down to the source's own (omp_base.cc:81-93)
    for lvl in range(d - 1, -1, -1):
        w = torch.where(depth == lvl + 1, (1.0 + delta) / sigma, 0.0)
        delta = torch.where(depth == lvl, sigma * pull_out(w), delta)
    return delta, d


def _normalized(scores: torch.Tensor) -> torch.Tensor:
    return scores / scores.max().clamp(min=1e-30)


def bc_batched(g, sources, *, layout: str = "auto",
               device="cuda") -> BCResult:
    """Batched multi-source Brandes: all S sources traverse at once in the
    last dimension, so S sources cost roughly one traversal's sweeps.
    Scores are summed over the sources and normalized by the max.  Takes
    the place of the reference's sequential num_iters loop
    (src/bc/omp_base.cc:69)."""
    scores, levels = batched_sums(g, sources, layout=layout,
                                  dev=resolve_device(device))
    return BCResult(_normalized(scores), levels)


def batched_sums(g, sources, *, layout: str, dev):
    """(f32[m] dependency sums over the sources, original order; forward
    levels) of bc_batched, before the normalization."""
    from gardenia_tpu_torch.solvers.bfs import _resolve_layout
    layout = _resolve_layout(layout)
    m = g.m
    sources = torch.from_numpy(np.asarray(sources, np.int64)).to(dev)
    S = sources.shape[0]
    if layout == "hybrid":
        from gardenia_tpu_torch.ops.bsr import spmv_hybrid_batched
        _, hyb_in, new_of_old = views.relabeled_hybrid(g, dev)
        _, hyb_out, _ = views.relabeled_hybrid(g, dev, reverse=False)
        sources = new_of_old[sources]

        def pull_in(x):
            return spmv_hybrid_batched(hyb_in, x, num_rows=m)

        def pull_out(x):
            return spmv_hybrid_batched(hyb_out, x, num_rows=m)
    else:
        from gardenia_tpu_torch.ops.spmv import spmv_batched
        new_of_old = None
        in_dst, in_src = views.coo_sorted(g, dev, reverse=True)
        out_src, out_dst = views.coo_sorted(g, dev)

        def pull_in(x):
            return spmv_batched(in_dst, in_src, x, num_rows=m)

        def pull_out(x):
            return spmv_batched(out_src, out_dst, x, num_rows=m)
    j = torch.arange(S, device=dev)
    depth = torch.full((m, S), INF, dtype=torch.int32, device=dev)
    depth[sources, j] = 0
    sigma = torch.zeros((m, S), dtype=torch.float32, device=dev)
    sigma[sources, j] = 1.0
    delta, levels = _brandes(pull_in, pull_out, depth, sigma)
    scores = delta.sum(dim=1)
    if new_of_old is not None:
        scores = scores[new_of_old]
    return scores, levels


@spanned("solve.bc")
def bc_solver(g, source: int = 0, *, num_sources: int = 1,
              device="cuda") -> BCResult:
    """Reference entry BCSolver(g, source, scores) (src/bc/bc.h:37).
    num_sources > 1 runs the batched path on consecutive sources starting
    at `source` (the reference iterates them serially, omp_base.cc:69)."""
    if num_sources > 1:
        sources = (np.arange(num_sources) + source) % g.m
        return bc_batched(g, sources, device=device)
    dev = resolve_device(device)
    m = g.m
    in_ell = views.ell(g, dev, reverse=True)
    out_ell = views.ell(g, dev)

    def pull_in(x):
        return spmv_ell(in_ell, x, semiring=F32_PLUS_TIMES, num_rows=m)

    def pull_out(x):
        return spmv_ell(out_ell, x, semiring=F32_PLUS_TIMES, num_rows=m)

    def discover(frontier):
        return spmv_ell(in_ell, frontier.to(torch.int32),
                        semiring=I32_PLUS_TIMES, num_rows=m)

    depth = torch.full((m,), INF, dtype=torch.int32, device=dev)
    depth[source] = 0
    sigma = torch.zeros(m, dtype=torch.float32, device=dev)
    sigma[source] = 1.0
    delta, levels = _brandes(pull_in, pull_out, depth, sigma, discover)
    return BCResult(_normalized(delta), levels)
