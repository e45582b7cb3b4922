"""SymGS trials: gardenia_tpu_torch.solvers.symgs.symgs_solver on the port's
Graph of HPCG's matrix (the mix's diagonal on the diagonal, its
off-diagonal on every arc, HPCG's b: each row's sum, from the benchmark's
own degrees), one application a trial from one x0 drawn from the seed.
The first trial colours the graph once through the port's
solvers/vc.vc_solver (the port's default path, and HPCG's optimisation
phase, which lies outside its timed loop); every trial hands the solver
the same arrays, so it reuses its colour-ordered system.  An answer is
(x, colours).

Correct (configuration: float32 x within tolerance of the float64
application under the program's colouring, and that colouring proper):
  color_conflicts — arcs of the reference CSR whose ends share a colour,
      plus rows with a colour below 0, over the sampled answers; exact.
  x_gap — over the sampled answers, the largest max_i |x_i - r_i| /
      max_i |r_i|, r the float64 application of reference_symgs.py under
      the answer's colours.  Its limit lies between the sound runs'
      readings (float32 sums of 27 terms over 2 x C blocks) and the
      bfloat16 control's (PERF.md section 2).  An answer the reference
      cannot run (not one colour a row, or a colour below 0) reads 1.0.
Controls (CONTROLS, each in the program's place): the reference with
every product a_ij * x_j rounded to bfloat16, a step below the stated
float32; and the reference with the backward half left out.
"""

from __future__ import annotations

import numpy as np
import torch

from graphbench import generators, reference, reference_symgs

LIMITS = {"color_conflicts": 0, "x_gap": 1e-5}
CONTROLS = ("bfloat16", "forward_only")


def values(mix) -> tuple:
    """(diagonal, off-diagonal) of the mix; its b and x0 rules checked."""
    v = mix["values"]
    if v["b"] != "hpcg" or v["x0"] != "uniform01":
        raise ValueError(f"unknown b or x0 rule in {v}")
    return float(v["diagonal"]), float(v["off_diagonal"])


def plan(edges, cfg, mix, seed) -> dict:
    diagonal, off = values(mix)
    g = reference.clean_csr(edges.m, edges.src, edges.dst,
                            bool(cfg["symmetrize"]))
    b = reference_symgs.rhs(g, diagonal, off)
    del g
    device = edges.src.device
    # a stream of its own: seed + 1 is the weights' (generators.generate)
    x0 = torch.rand(edges.m, generator=generators.device_generator(
        int(seed) + 2, device), device=device, dtype=torch.float32)
    return {"b": b, "x0": x0}


class Trials:
    def __init__(self, g, device, mix, plan):
        from gardenia_tpu_torch.solvers.symgs import symgs_solver
        from gardenia_tpu_torch.solvers.vc import vc_solver
        diagonal, off = values(mix)
        self.g, self.device = g, device
        self.Ax = np.full(g.nnz, off, np.float32)
        self.diag = np.full(g.m, diagonal, np.float32)
        self.b = plan["b"].cpu().numpy().astype(np.float32)
        self.x0 = plan["x0"].cpu().numpy()
        self.colors = None
        self.warmups = int(mix.get("warmups", 0))
        self._solve, self._color = symgs_solver, vc_solver

    def __call__(self, i):
        r = self._solve(self.g, self.Ax, self.x0, self.b, self.diag,
                        self.colors, device=self.device)
        return r.x, self.colors

    def first(self):
        self.colors = self._color(self.g,
                                  device=self.device).colors.cpu().numpy()
        return self(0)

    def warm(self, k):
        return self(0)


def _on(ref, colors) -> torch.Tensor:
    """int64 colours on the reference's device."""
    return torch.as_tensor(np.asarray(colors)).to(ref.cols.device,
                                                   torch.int64)


def color_conflicts(ref, colors) -> int:
    c = _on(ref, colors)
    if c.numel() != ref.m:
        return ref.m
    return int((c[ref.rows] == c[ref.cols]).sum()) + int((c < 0).sum())


def _applications(ref, mix, plan, outputs, **kwargs) -> dict:
    """{id of an answer's colours: the reference's float64 x under them,
    or None where the reference cannot run them}, one application for
    each distinct colouring."""
    diagonal, off = values(mix)
    b = plan["b"].to(ref.cols.device)
    out = {}
    for _, (_, colors) in outputs:
        if id(colors) not in out:
            c = _on(ref, colors)
            runs = c.numel() == ref.m and int(c.min()) >= 0
            out[id(colors)] = reference_symgs.symgs(
                ref, plan["x0"], b, c, diagonal=diagonal, off_diagonal=off,
                **kwargs) if runs else None
    return out


def check(outputs, ref, cfg, mix, plan) -> dict:
    diagonal, off = values(mix)
    want = _applications(ref, mix, plan, outputs)
    conflicts, gap, failed = 0, 0.0, 0
    for _, (x, colors) in outputs:
        bad = color_conflicts(ref, colors)
        r = want[id(colors)]
        one = 1.0 if r is None else float(
            (x.to(r) - r).abs().max() / r.abs().max())
        conflicts += bad
        gap = max(gap, one)
        failed += int(bad > LIMITS["color_conflicts"]
                      or one > LIMITS["x_gap"])
    info = {"answers_checked": len(outputs), "answers_wrong": failed,
            "vertices": ref.m, "arcs": ref.arcs}
    if outputs:
        colors = outputs[0][1][1]
        r = want[id(colors)]
        b = plan["b"].to(ref.cols.device)
        info["num_colors"] = int(np.max(colors)) + 1
        info["residual_x0"] = reference_symgs.residual(
            ref, plan["x0"], b, diagonal=diagonal, off_diagonal=off)
        if r is not None:
            info["residual_after"] = reference_symgs.residual(
                ref, r, b, diagonal=diagonal, off_diagonal=off)
    return {"numbers": [("color_conflicts", conflicts,
                         LIMITS["color_conflicts"]),
                        ("x_gap", gap, LIMITS["x_gap"])],
            "failed": failed, "info": info}


def control(ref, cfg, mix, plan, outputs):
    out = []
    for name in CONTROLS:
        xs = _applications(ref, mix, plan, outputs,
                           round_to=torch.bfloat16 if name == "bfloat16"
                           else None, backward=name != "forward_only")
        out += [(i, (xs[id(colors)], colors)) for i, (_, colors) in outputs]
    return out
