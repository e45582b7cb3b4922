"""SSSP trials: gardenia_tpu_torch.solvers.sssp.sssp_solver on the port's
weighted Graph with the mix's arguments (delta-stepping: the lowest
occupied bucket's vertices relaxed a round, by a compacted expansion and
a scatter-min when their out-edges are few, else by the int32 min-plus
sweep over the weighted in-ELL), from sources drawn as kernels/bfs.py
draws them (GAP's rule, the benchmark's own degrees).  The plan keeps the
raw edges and their weights, which run.py holds until the check anyway,
for the weighted reference (reference_sssp.py).

Correct (configuration: exact int32 distances, every reachable vertex
settled):
  dist_mismatch — over the sampled trials, the vertices whose distance
      differs from the reference's (unreached on both sides agrees).
Controls (CONTROLS, every one in the program's place): the reference
with each candidate dist + w rounded to bfloat16, a step below the
stated int32, which is exact only up to 256; and the reference stopped
one relax round short of its fixed point.
"""

from __future__ import annotations

import torch

from graphbench import reference_sssp
from graphbench.kernels import bfs

LIMITS = {"dist_mismatch": 0}
CONTROLS = ("bfloat16", "one_round_short")


def plan(edges, cfg, mix, seed) -> dict:
    out = bfs.plan(edges, cfg, mix, seed)
    out["edges"] = (edges.m, edges.src, edges.dst, edges.wt)
    return out


class Trials(bfs.Trials):
    def __init__(self, g, device, mix, plan):
        from gardenia_tpu_torch.solvers.sssp import sssp_solver
        super().__init__(g, device, mix, plan)
        self._solve = sssp_solver

    def _run(self, source):
        r = self._solve(self.g, source, device=self.device, **self.args)
        return source, r.dist, int(r.iterations)


def weighted_graph(cfg, plan) -> reference_sssp.WeightedGraph:
    m, src, dst, wt = plan["edges"]
    return reference_sssp.weighted_csr(m, src, dst, wt,
                                       bool(cfg["symmetrize"]))


def check(outputs, ref, cfg, mix, plan) -> dict:
    g = weighted_graph(cfg, plan)
    total, failed, arcs, far = 0, 0, [], 0
    for _, (source, dist, _) in outputs:
        want, _ = reference_sssp.distances(g, source)
        bad = bfs._mismatch(dist, want)
        total += bad
        failed += int(bad > 0)
        arcs.append(reference_sssp.reached_arcs(g, want))
        far = max(far, int(want.max()))
    rounds = [it for _, (_, _, it) in outputs if it is not None]
    info = {"sources_checked": len(outputs), "answers_wrong": failed,
            "reached_arcs": sum(arcs) / len(arcs) if arcs else None,
            "largest_distance": far}
    if rounds:
        info.update(rounds_mean=sum(rounds) / len(rounds),
                    rounds_min=min(rounds), rounds_max=max(rounds))
    return {"numbers": [("dist_mismatch", total, LIMITS["dist_mismatch"])],
            "failed": failed, "info": info}


def control(ref, cfg, mix, plan, outputs):
    g = weighted_graph(cfg, plan)
    out = []
    for name in CONTROLS:
        for i, (source, _, _) in outputs:
            if name == "bfloat16":
                dist, _ = reference_sssp.distances(g, source,
                                                   round_to=torch.bfloat16)
            else:
                _, rounds = reference_sssp.distances(g, source)
                dist, _ = reference_sssp.distances(
                    g, source, max_rounds=max(rounds - 1, 0))
            out.append((i, (source, dist, None)))
    return out
