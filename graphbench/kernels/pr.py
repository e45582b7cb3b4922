"""PageRank trials: gardenia_tpu_torch.solvers.pr.pr_solver on the
port's Graph, with the mix's arguments (pull, layout auto = the
degree-relabelled hybrid: K1 on the dense panels, spmv_ell on the ELL
remainder), each trial a whole solve from the initial scores to the
scores in original ids.

Correct (configuration: float32 scores, L1 tolerance epsilon):
  score_gap     — the widest relative gap |s - r| / r over the vertices,
      r the float64 reference after the same number of iterations;
  iteration_gap — how far the program's iteration count lies from the
      reference's stop, the first iteration whose L1 change is under
      epsilon: exact, 0.  A solve that stops one iteration early or late
      reads 1.  The program sums its L1 change in float32, so it could
      stop elsewhere by rounding alone only where the reference's change
      at the stop, or one iteration before it, lies within that rounding
      of epsilon; the info gives both over epsilon (stop_margin: under 1
      and at least 1), so every run shows how far it is from that edge.
Control: the reference with its contributions rounded to bfloat16 (the
operand a tensor-core product would take), summed in float32.
"""

from __future__ import annotations

import torch

from graphbench import reference

# score_gap: sound runs read at most 9.0e-7 (kron20) and 3.4e-7 (urand20)
# over 12 seeds each, the bfloat16 control at least 3.2e-3 and 1.3e-3;
# iteration_gap: exact (PERF.md §2)
LIMITS = {"score_gap": 1e-4, "iteration_gap": 0}


def plan(edges, cfg, mix, seed) -> dict:
    return {}


class Trials:
    def __init__(self, g, device, mix, plan):
        from gardenia_tpu_torch.solvers.pr import pr_solver
        self.g, self.device = g, device
        self.args = dict(mix["solver_args"])
        self.warmups = int(mix.get("warmups", 2))
        self._solve = pr_solver

    def __call__(self, i):
        r = self._solve(self.g, device=self.device, **self.args)
        return r.scores, int(r.iterations)

    def first(self):
        return self(0)

    def warm(self, k):
        return self(0)


def check(outputs, ref, cfg, mix, plan) -> dict:
    eps = float(mix["solver_args"]["epsilon"])
    iters = {it for _, (_, it) in outputs}
    kept, errs, stop = reference.pagerank(ref, eps, keep=iters)
    gap, it_gap, failed = 0.0, 0, 0
    for _, (scores, it) in outputs:
        r = kept[it]
        rel = float(((scores.to(r.dtype) - r).abs() / r).max())
        gap, it_gap = max(gap, rel), max(it_gap, abs(it - stop))
        failed += int(rel > LIMITS["score_gap"]
                      or abs(it - stop) > LIMITS["iteration_gap"])
    margin = [errs[stop - 1] / eps, errs[stop - 2] / eps if stop > 1
              else None]
    return {"numbers": [("score_gap", gap, LIMITS["score_gap"]),
                        ("iteration_gap", it_gap, LIMITS["iteration_gap"])],
            "failed": failed,
            "info": {"pr_iterations": stop,
                     "program_iterations": sorted(iters),
                     "stop_margin": margin}}


def control(ref, cfg, mix, plan, outputs):
    eps = float(mix["solver_args"]["epsilon"])
    kept, _, stop = reference.pagerank(ref, eps, keep_stop=True,
                                       value_dtype=torch.float32,
                                       operand_dtype=torch.bfloat16)
    return [(0, (kept[stop], stop))]
