#!/usr/bin/env python3
"""Probe of the port's multi-device layer on the card(s) at hand.

    python3 scripts/probe_dist.py [--ranks 2] [--scale 10] [--device cuda]

1. Which collectives the group of `--ranks` ranks takes on CUDA tensors
   (all_gather_into_tensor and all_reduce sum/max/min of f32, int32 and
   int64), each called directly and its result read back, with the mesh's backend (gloo when the
   ranks outnumber the cards, nccl otherwise); prints one JSON line.
2. The dist solvers (PR hybrid and ell, BFS hybrid and ell, MS-BFS-dp,
   TC, VC, SCC) at R-MAT-`--scale` on 1 rank and on `--ranks` ranks, each
   held to the serial oracles or the single-device solver, with K1's
   launches counted on every rank; exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def collectives(mesh):
    """{collective dtype: 'ok' | the error} for this rank's group."""
    import torch
    import torch.distributed as dist
    from gardenia_tpu_torch.parallel import mesh as M
    out = {"backend": mesh.backend, "device": str(mesh.device),
           "torch": torch.__version__}
    for dt in (torch.float32, torch.int32, torch.int64):
        t = torch.arange(4, device=mesh.device).to(dt) + mesh.rank
        try:
            o = t.new_empty(4 * mesh.size)
            dist.all_gather_into_tensor(o, t)
            out[f"all_gather {dt}"] = "ok" if o.tolist()[4:8] == \
                (torch.arange(4) + 1).tolist() else f"wrong {o.tolist()}"
        except Exception as e:                     # the probe's answer
            out[f"all_gather {dt}"] = f"{type(e).__name__}: {e}"[:200]
        for op in ("sum", "max", "min"):
            b = t.clone()
            try:
                dist.all_reduce(b, op=M._OPS[op])
                want = {"sum": sum, "max": max, "min": min}[op](
                    range(mesh.size))
                out[f"all_reduce {op} {dt}"] = "ok" if int(b[0]) == want \
                    else f"wrong {b.tolist()}"
            except Exception as e:                 # the probe's answer
                out[f"all_reduce {op} {dt}"] = f"{type(e).__name__}: {e}"[:200]
    return out


def solves(mesh, g, gd):
    """The dist solvers' results and this rank's K1 launches."""
    from gardenia_tpu_torch.ops import panel
    from gardenia_tpu_torch.parallel import (bfs_multi_source_dist,
                                             bfs_solver_dist, pr_solver_dist,
                                             scc_solver_dist, tc_solver_dist,
                                             vc_solver_dist)
    out, launches = {}, {}
    for name, fn in (
            ("pr", lambda: pr_solver_dist(g, mesh=mesh)),
            ("pr_ell", lambda: pr_solver_dist(g, mesh=mesh, layout="ell")),
            ("bfs", lambda: bfs_solver_dist(gd, 3, mesh=mesh)),
            ("bfs_ell", lambda: bfs_solver_dist(gd, 3, mesh=mesh,
                                                layout="ell")),
            ("msbfs", lambda: bfs_multi_source_dist(
                g, np.arange(16), mesh=mesh)),
            ("tc", lambda: tc_solver_dist(g, mesh=mesh)),
            ("vc", lambda: vc_solver_dist(g, mesh=mesh)),
            ("scc", lambda: scc_solver_dist(gd, mesh=mesh))):
        before = dict(panel.LAUNCHES)
        t0 = time.perf_counter()
        out[name] = fn()
        out[name + "_s"] = time.perf_counter() - t0
        launches[name] = {r: panel.LAUNCHES[r] - before[r] for r in before}
    out["k1"] = launches
    out["mesh"] = mesh.describe()
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--scale", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    from gardenia_tpu_torch.core.generate import generate_graph
    from gardenia_tpu_torch.parallel import run_on_ranks
    from gardenia_tpu_torch.solvers.pr import pr_solver
    from gardenia_tpu_torch.verify import oracles
    print(json.dumps(run_on_ranks(collectives, args.ranks, args.device)[0]))
    g = generate_graph("rmat", scale=args.scale, degree=8, symmetrize=True,
                       need_reverse=True)
    gd = generate_graph("rmat", scale=args.scale, degree=4,
                        symmetrize=False, need_reverse=True)
    ref = pr_solver(g, device=args.device)
    bad = 0
    for n in (1, args.ranks):
        t0 = time.perf_counter()
        res = run_on_ranks(solves, n, args.device, g, gd)
        r = res[0]
        checks = {
            "pr": r["pr"].iterations == ref.iterations and float(
                (r["pr"].scores - ref.scores.cpu()).abs().max()) < 1e-6,
            "pr_ell": float((r["pr_ell"].scores - ref.scores.cpu()).abs()
                            .max()) < 1e-6,
            "bfs": bool((r["bfs"].dist.numpy() ==
                         oracles.bfs_serial(gd, 3)).all()),
            "bfs_ell": bool((r["bfs_ell"].dist.numpy() ==
                             oracles.bfs_serial(gd, 3)).all()),
            "msbfs": all((r["msbfs"].dist[:, j].numpy() ==
                          oracles.bfs_serial(g, j)).all() for j in range(16)),
            "tc": r["tc"] == oracles.tc_serial(g.oriented()),
            "vc": oracles.vc_check(g, r["vc"].colors.numpy()),
            "scc": len(np.unique(r["scc"].scc_root.numpy())) ==
            len(np.unique(oracles.scc_serial(gd)))}
        bad += sum(not v for v in checks.values())
        print(f"{r['mesh']}: {time.perf_counter() - t0:.1f} s, checks "
              f"{json.dumps(checks)}, K1 launches by rank "
              f"{json.dumps([x['k1'] for x in res])}, solve s "
              + json.dumps({k: round(v, 3) for k, v in r.items()
                            if k.endswith('_s')}))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
