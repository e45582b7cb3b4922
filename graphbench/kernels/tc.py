"""Triangle-counting trials: gardenia_tpu_torch.solvers.tc.tc_solver on
the port's Graph with the mix's arguments (rotate: the relabelled DAG,
the hub bitmap through H1, the width-classed pair streams through K3 and
K4), each trial a whole count.

Correct (configuration: an exact count):
  count_gap — over every trial of the window, the largest difference
      from the reference's count.
Control: the reference's hits summed and accumulated in float32, which
breaks the stated exactness once the count passes 2^24.
"""

from __future__ import annotations

import torch

from graphbench import reference

LIMITS = {"count_gap": 0}
# the control's accumulator: float32 holds every whole number only up to
# 2^24, and kron20 has some 4e8 triangles
CONTROL_ACCUMULATE = torch.float32


def plan(edges, cfg, mix, seed) -> dict:
    return {}


class Trials:
    def __init__(self, g, device, mix, plan):
        from gardenia_tpu_torch.solvers.tc import tc_solver
        self.g, self.device = g, device
        self.args = dict(mix["solver_args"])
        self.warmups = int(mix.get("warmups", 2))
        self._solve = tc_solver

    def __call__(self, i):
        return int(self._solve(self.g, device=self.device, **self.args))

    def first(self):
        return self(0)

    def warm(self, k):
        return self(0)


def check(outputs, ref, cfg, mix, plan) -> dict:
    want = reference.triangles(ref)
    gaps = [abs(count - want) for _, count in outputs]
    return {"numbers": [("count_gap", max(gaps), LIMITS["count_gap"])],
            "failed": sum(1 for x in gaps if x > LIMITS["count_gap"]),
            "info": {"triangles": want}}


def control(ref, cfg, mix, plan, outputs):
    return [(0, reference.triangles(ref, accumulate=CONTROL_ACCUMULATE))]
