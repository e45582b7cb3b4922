"""Where a solve's device time goes, by torch.profiler on a CUDA card.

    python -m gardenia_tpu_torch.profile_solve [--kernel {pr,tc}]
        [--scale 20] [--solves 3] [--trace chiprun_out/trace.json]

On the bench's graph (bench.get_graph): one untraced solve that builds
and uploads (layout or TC prep), then `--solves` untraced solves timed on
the host clock after cuda.synchronize, then `--solves` solves under
torch.profiler.  It prints nvidia-smi's name and power limit, the
device busy time summed over the traced solves, the span from the first
device event's start to the last one's end, the idle share of that span
(1 - busy / span), and busy ms and launch count by kernel name.
`--trace` also writes the Chrome trace.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch


def solver(kernel: str):
    if kernel == "pr":
        from gardenia_tpu_torch.solvers.pr import pr_solver
        return pr_solver
    from gardenia_tpu_torch.solvers.tc import tc_solver
    return tc_solver


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gardenia_tpu_torch."
                                      "profile_solve")
    ap.add_argument("--kernel", default="tc", choices=["pr", "tc"])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--solves", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_solve: needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from gardenia_tpu_torch.bench import get_graph
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    solve = solver(args.kernel)
    g = get_graph(args.scale)
    t0 = time.perf_counter()
    solve(g, device=dev)
    torch.cuda.synchronize()
    print(f"first solve (build, upload) {time.perf_counter() - t0} s")
    walls = []
    for _ in range(args.solves):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve(g, device=dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"untraced solves ms {walls}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.solves):
            solve(g, device=dev)
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.device_time > 0]
    if not events:
        sys.exit("profile_solve: the trace holds no device time")
    by_name = {}
    for e in events:
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + e.device_time / 1e3)
    busy = sum(ms for _, ms in by_name.values())
    span = (max(e.time_range.end for e in events)
            - min(e.time_range.start for e in events)) / 1e3
    print(f"{args.kernel} rmat{args.scale}: {len(events)} device events "
          f"over {args.solves} solves, busy {busy} ms, span {span} ms, "
          f"idle share {1 - busy / span}")
    for name, (n, ms) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        print(f"  {ms:10.3f} ms {n:5d}x {name[:110]}")
    if args.trace:
        os.makedirs(os.path.dirname(os.path.abspath(args.trace)),
                    exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
