"""BFS trials: gardenia_tpu_torch.solvers.bfs.bfs_solver on the port's
Graph with the mix's arguments (do_fused: the direction chosen a level
from graduated tiers, the dense level through the hybrid count sweep),
from sources drawn by GAP's rule: uniformly, with replacement, among the
vertices of non-zero degree, from a generator seeded by the run's seed.
The degrees are the benchmark's own (reference.clean_csr), not the
port's.

Correct (configuration: exact hop depths):
  depth_mismatch — over the sampled trials, the vertices whose depth
      differs from the reference's (unreached on both sides agrees).
Control: the reference BFS stopped one level early (its deepest level
left unreached), which breaks the stated guarantee.
"""

from __future__ import annotations

import numpy as np
import torch

from graphbench import reference

UNREACHED = 1_000_000_000     # the port's MYINFINITY (GARDENIA common.h)
LIMITS = {"depth_mismatch": 0}


def plan(edges, cfg, mix, seed) -> dict:
    g = reference.clean_csr(edges.m, edges.src, edges.dst,
                            bool(cfg["symmetrize"]))
    pool = torch.nonzero(g.degrees > 0).flatten().cpu().numpy()
    del g
    rng = np.random.default_rng(int(seed))
    n = int(mix["sources"]["count"])
    warm = int(mix.get("warmups", 0)) + 1
    return {"sources": pool[rng.integers(0, len(pool), n)],
            "warm_sources": pool[rng.integers(0, len(pool), warm)],
            "candidates": len(pool)}


class Trials:
    def __init__(self, g, device, mix, plan):
        from gardenia_tpu_torch.solvers.bfs import bfs_solver
        self.g, self.device = g, device
        self.args = dict(mix["solver_args"])
        self.sources = plan["sources"]
        self.warm_sources = plan["warm_sources"]
        self.warmups = int(mix.get("warmups", 0))
        self._solve = bfs_solver

    def _run(self, source):
        r = self._solve(self.g, source, device=self.device, **self.args)
        return source, r.dist

    def __call__(self, i):
        return self._run(int(self.sources[i % len(self.sources)]))

    def first(self):
        return self._run(int(self.warm_sources[0]))

    def warm(self, k):
        return self._run(int(self.warm_sources[1 + k]))


def _mismatch(dist, ref_dist) -> int:
    prog = torch.where(dist.to(torch.int64) >= UNREACHED, -1,
                       dist.to(torch.int64))
    return int((prog != ref_dist).sum())


def check(outputs, ref, cfg, mix, plan) -> dict:
    total, failed = 0, 0
    for _, (source, dist) in outputs:
        bad = _mismatch(dist, reference.bfs(ref, source))
        total += bad
        failed += int(bad > 0)
    return {"numbers": [("depth_mismatch", total,
                         LIMITS["depth_mismatch"])],
            "failed": failed, "info": {"sources_checked": len(outputs)}}


def control(ref, cfg, mix, plan, outputs):
    return [(i, (source, reference.bfs(ref, source, drop_last_level=True)))
            for i, (source, _) in outputs]
