"""Where a solve's device time goes, by torch.profiler on a CUDA card.

    python -m gardenia_tpu_torch.profile_solve
        [--kernel {pr,tc,cc,bfs,msbfs,bc,spmv,sssp,scc,mst,vc,symgs,sgd,
                   kcl,motif,sgl,fsm}]
        [--graph {rmat,uniform}] [--scale 20] [--solves 3]
        [--trace chiprun_out/trace.json] [--ranks N]

On the bench's graph (bench.get_graph; `--graph uniform`: the uniform
random graph of the same scale and degree, on which cc_sv takes a dense
round; sssp: the bench's weighted grid of side 2^(scale // 2); scc: the
directed R-MAT graph; mst: the R-MAT graph with the bench's hash
weights; sgd: the R-MAT graph with the bench's ratings), with the bench's
solver (cc: cc_sv; bfs:
bfs_do_fused from the vertex of highest degree; msbfs and bc: sources
0..127; spmv: the bench's 8 hybrid applies on the PR layout with scale
0.2; sssp: nearfar from vertex 0 with delta 1024; scc: 'color'; symgs:
the bench's inputs and colouring; sgd: 10 epochs at step 0.1 from the
bench's latent tables; kcl: kcl_solver at k = 4 through Q1; motif: the
4-motif census; sgl: sgl_solver's diamond formula; fsm: fsm_solver at
k = 2, minsup 5000, on the degree-bucket labels): one
untraced solve that
builds and uploads (layout or TC prep), then `--solves` untraced solves
timed on the host clock after cuda.synchronize, then `--solves` solves
under torch.profiler.  It prints nvidia-smi's name and power limit, the
device busy time summed over the traced solves, the span from the first
device event's start to the last one's end, the idle share of that span
(1 - busy / span), and busy ms and launch count by kernel name.
`--trace` also writes the Chrome trace.  Needs a CUDA card.

`--ranks N` (pr, bfs, msbfs, tc, vc, scc, cc, sssp) profiles the
multi-device solver of gardenia_tpu_torch.parallel instead, on N local
ranks on the card(s) at hand (parallel/mesh.py's plan: gloo when the
ranks outnumber the cards), each rank profiling its own process: per rank
the same numbers, the panel kernels' busy ms and share (K1, K2 and M1:
the kernels named panel_matmul or minselect), and the card's busy share
at most (the ranks' busy summed over the longest span: their events may
overlap).  sssp runs there on the R-MAT graph, unweighted, from its
vertex of highest degree; cc with the hybrid layout.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from functools import partial

import torch


def solver(kernel: str, g):
    """fn(g, device=) running the bench's solve of `kernel` on g."""
    import numpy as np
    if kernel == "pr":
        from gardenia_tpu_torch.solvers.pr import pr_solver
        return pr_solver
    if kernel == "cc":
        from gardenia_tpu_torch.solvers.cc import cc_sv
        return cc_sv
    if kernel == "bfs":
        from gardenia_tpu_torch.solvers.bfs import bfs_do_fused
        return partial(bfs_do_fused, source=int(np.argmax(g.degrees)))
    if kernel == "msbfs":
        from gardenia_tpu_torch.bench import SOURCES
        from gardenia_tpu_torch.solvers.bfs import bfs_multi_source
        return partial(bfs_multi_source, sources=np.arange(SOURCES))
    if kernel == "bc":
        from gardenia_tpu_torch.bench import SOURCES
        from gardenia_tpu_torch.solvers.bc import bc_batched
        return partial(bc_batched, sources=np.arange(SOURCES))
    if kernel == "spmv":
        from gardenia_tpu_torch.bench import spmv_applies
        return spmv_applies
    if kernel == "sssp":
        from gardenia_tpu_torch.bench import SSSP_DELTA
        from gardenia_tpu_torch.solvers.sssp import sssp_solver
        return partial(sssp_solver, source=0, delta=SSSP_DELTA,
                       variant="nearfar")
    if kernel == "scc":
        from gardenia_tpu_torch.solvers.scc import scc_solver
        return scc_solver
    if kernel == "mst":
        from gardenia_tpu_torch.solvers.mst import mst_solver
        return mst_solver
    if kernel == "vc":
        from gardenia_tpu_torch.solvers.vc import vc_solver
        return vc_solver
    if kernel == "symgs":
        from gardenia_tpu_torch.solvers.symgs import (default_inputs,
                                                      symgs_solver)

        def symgs(g, device):
            return symgs_solver(g, *default_inputs(g, device), device=device)
        return symgs
    if kernel == "sgd":
        from gardenia_tpu_torch.bench import SGD_EPOCHS, SGD_STEP, sgd_init
        from gardenia_tpu_torch.solvers.sgd import sgd_solver

        def sgd(g, device):
            init = g._dev(("torch", "sgd_bench_init", str(device)),
                          lambda: sgd_init(g, device))
            return sgd_solver(g, step=SGD_STEP, max_iters=SGD_EPOCHS,
                              epsilon=0.0, init=init, device=device)
        return sgd
    if kernel == "kcl":
        from gardenia_tpu_torch.mining.kcl import kcl_solver
        return partial(kcl_solver, k=4)
    if kernel == "motif":
        from gardenia_tpu_torch.mining.motif import motif_solver
        return partial(motif_solver, k=4)
    if kernel == "sgl":
        from gardenia_tpu_torch.mining.sgl import sgl_solver
        return partial(sgl_solver, pattern="diamond")
    if kernel == "fsm":
        from gardenia_tpu_torch.bench import FSM_K, FSM_MINSUP
        from gardenia_tpu_torch.mining.fsm import fsm_solver
        return partial(fsm_solver, k=FSM_K, minsup=FSM_MINSUP)
    from gardenia_tpu_torch.solvers.tc import tc_solver
    return tc_solver


DIST_KERNELS = ("pr", "bfs", "msbfs", "tc", "vc", "scc", "cc", "sssp")


def dist_solver(kernel: str, g):
    """fn(g, mesh=) running the multi-device solve of `kernel` on g (bfs
    and sssp: from the vertex of highest degree; msbfs: sources
    0..127)."""
    import numpy as np
    from gardenia_tpu_torch import parallel as P
    if kernel in ("bfs", "sssp"):
        fn = P.bfs_solver_dist if kernel == "bfs" else P.sssp_solver_dist
        return partial(fn, source=int(np.argmax(g.degrees)))
    if kernel == "msbfs":
        from gardenia_tpu_torch.bench import SOURCES
        return partial(P.bfs_multi_source_dist, sources=np.arange(SOURCES))
    return {"pr": P.pr_solver_dist, "tc": P.tc_solver_dist,
            "vc": P.vc_solver_dist, "scc": P.scc_solver_dist,
            "cc": P.cc_solver_dist}[kernel]


def profiled(solve, solves: int) -> dict:
    """solve() once (build, upload), `solves` times on the host clock
    after cuda.synchronize, then `solves` times under torch.profiler:
    {"first_s", "walls_ms", "events": [(name, device_us, start_us,
    end_us)] of the device events}."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    walls = []
    for _ in range(solves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(solves):
            solve()
        torch.cuda.synchronize()
    return {"first_s": first_s, "walls_ms": walls, "prof": prof,
            "events": [(e.name, e.device_time, e.time_range.start,
                        e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and e.device_time > 0]}


def summary(events) -> tuple:
    """(busy ms, span ms, {name: (launches, busy ms)}) of device events."""
    by_name = {}
    for name, us, _, _ in events:
        n, ms = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, ms + us / 1e3)
    busy = sum(ms for _, ms in by_name.values())
    span = (max(e[3] for e in events) - min(e[2] for e in events)) / 1e3
    return busy, span, by_name


def traced_rank(mesh, kernel: str, g, solves: int) -> dict:
    """One rank of `--ranks`: profiled() of its dist solve."""
    out = profiled(partial(dist_solver(kernel, g), g, mesh=mesh), solves)
    del out["prof"]
    out["mesh"] = mesh.describe()
    return out


def dist_main(args) -> None:
    from gardenia_tpu_torch.core.graph import from_csr_of
    from gardenia_tpu_torch.parallel import run_on_ranks
    # the dist SSSP runs on the R-MAT graph, not on the bench's grid
    g = from_csr_of(bench_graph("pr" if args.kernel == "sssp" else
                                args.kernel, args.graph, args.scale))
    ranks = run_on_ranks(traced_rank, args.ranks, "cuda", args.kernel, g,
                         args.solves)
    print(f"{args.kernel} dist {args.graph}{args.scale}: {ranks[0]['mesh']}")
    sums, spans = 0.0, []
    for r, res in enumerate(ranks):
        if not res["events"]:
            sys.exit(f"profile_solve: rank {r}'s trace holds no device time")
        busy, span, by_name = summary(res["events"])
        panels = sum(ms for name, (_, ms) in by_name.items()
                     if "panel_matmul" in name or "minselect" in name)
        sums += busy
        spans.append(span)
        print(f"rank {r}: first solve {res['first_s']} s, untraced solves ms "
              f"{res['walls_ms']}; {len(res['events'])} device events over "
              f"{args.solves} solves, busy {busy} ms, span {span} ms, idle "
              f"share {1 - busy / span}; panel kernels (K1, K2, M1) "
              f"{panels} ms, {panels / busy} of busy")
        for name, (n, ms) in sorted(by_name.items(),
                                    key=lambda kv: -kv[1][1])[:12]:
            print(f"  {ms:10.3f} ms {n:5d}x {name[:110]}")
    print(f"the card: busy share at most {min(1.0, sums / max(spans))} "
          f"(the ranks' busy {sums} ms over the longest span {max(spans)} "
          f"ms)")


def bench_graph(kernel: str, kind: str, scale: int):
    """The graph the bench runs `kernel` on (kind: rmat or uniform)."""
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.core.generate import generate_graph
    if kernel == "sssp":
        return bench.sssp_graph(scale)
    if kernel == "scc":
        return bench.get_graph_directed(scale)
    if kernel == "mst":
        return bench.mst_graph(bench.get_graph(scale))
    if kernel == "sgd":
        return bench.sgd_graph(bench.get_graph(scale))
    return (bench.get_graph(scale) if kind == "rmat" else
            generate_graph("uniform", scale=scale, degree=16,
                           symmetrize=True))


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gardenia_tpu_torch."
                                      "profile_solve")
    ap.add_argument("--kernel", default="tc",
                    choices=["pr", "tc", "cc", "bfs", "msbfs", "bc", "spmv",
                             "sssp", "scc", "mst", "vc", "symgs", "sgd",
                             "kcl", "motif", "sgl", "fsm"])
    ap.add_argument("--graph", default="rmat", choices=["rmat", "uniform"])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--ranks", type=int, default=None,
                    help="profile the multi-device solver on N local ranks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_solve: needs a CUDA card")
    if args.ranks is not None and args.kernel not in DIST_KERNELS:
        sys.exit(f"profile_solve: --ranks takes {', '.join(DIST_KERNELS)}")

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.ranks is not None:
        return dist_main(args)
    dev = torch.device("cuda")
    g = bench_graph(args.kernel, args.graph, args.scale)
    solve = solver(args.kernel, g)
    res = profiled(partial(solve, g, device=dev), args.solves)
    print(f"first solve (build, upload) {res['first_s']} s")
    print(f"untraced solves ms {res['walls_ms']}")
    events, prof = res["events"], res["prof"]
    if not events:
        sys.exit("profile_solve: the trace holds no device time")
    busy, span, by_name = summary(events)
    print(f"{args.kernel} {args.graph}{args.scale}: {len(events)} device "
          f"events over {args.solves} solves, busy {busy} ms, span {span} ms, "
          f"idle share {1 - busy / span}")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  {ms:10.3f} ms {n:5d}x {name[:110]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
