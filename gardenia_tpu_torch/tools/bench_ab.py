"""Run the port's bench from several source trees in turns, to tell a
change of the code from a change of the host.

    python -m gardenia_tpu_torch.tools.bench_ab TREE_A TREE_B \\
        [--kernels pr,bfs,spmv,symgs] [--rounds 2] [--scale 20] \\
        [--device cuda]

Each tree is a checkout of the repository (e.g. `git archive <commit>`
unpacked).  For each kernel, each round runs `python -m
gardenia_tpu_torch.bench --kernel K` once in every tree, in the order
the trees are given (A, B, A, B for two rounds), each in a fresh process
whose working directory is the tree, so that it imports that tree's
package and builds that tree's kernels.  Both trees thus see the same
host state.

Printed: once, the host's CPU (`lscpu`'s CPU_FIELDS), its cores (`nproc`) and
the card's name and power limit (`nvidia-smi`); before each run the
host's load (`uptime`); a JSON line a run, `{"tree", "kernel", "round",
"value", "record"}`; and last, a JSON line a kernel with each tree's
values, their median and spread ((max - min) / median), each tree's
median over the first tree's, and whether the trees' ranges overlap.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys


def _shell(cmd: list) -> str:
    """The command's output, or what kept it from running."""
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"n/a ({type(e).__name__})"
    return proc.stdout.strip() or proc.stderr.strip()


RUN_TIMEOUT_S = 900         # one bench run at R-MAT-20 takes ~20-60 s

# lscpu's fields that name the CPU (a virtual machine may report its
# model name as unknown and still give the family, model and stepping)
CPU_FIELDS = ("Model name", "Vendor ID", "CPU family", "Model", "Stepping",
              "BogoMIPS", "L3 cache")


def host_lines(device: str) -> list:
    """The host's CPU model, cores, load, and the card's name and power
    limit, as the tools named in the docstring print them."""
    fields = dict(ln.split(":", 1) for ln in _shell(["lscpu"]).splitlines()
                  if ":" in ln)
    cpu = [f"{k}: {fields[k].strip()}" for k in CPU_FIELDS if k in fields]
    lines = ["; ".join(cpu) if cpu else "Model name: n/a",
             f"nproc: {_shell(['nproc'])}",
             f"uptime: {_shell(['uptime'])}"]
    if device == "cuda":
        lines.append(_shell(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"]))
    return lines


def run_bench(tree: str, kernel: str, scale: int, device: str) -> dict:
    """The bench's JSON record of one run in tree (a fresh process)."""
    proc = subprocess.run(
        [sys.executable, "-m", "gardenia_tpu_torch.bench", "--kernel",
         kernel, "--scale", str(scale), "--device", device],
        cwd=tree, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"bench --kernel {kernel} in {tree} exited "
                           f"{proc.returncode}: {proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def summary(kernel: str, trees: list, values: dict) -> dict:
    """Each tree's values, median and spread, its median over the first
    tree's, and whether every tree's range overlaps the first's."""
    out = {"kernel": kernel, "trees": {}}
    base = statistics.median(values[trees[0]])
    lo0, hi0 = min(values[trees[0]]), max(values[trees[0]])
    overlap = True
    for t in trees:
        v = values[t]
        med = statistics.median(v)
        out["trees"][t] = {"values": v, "median": med,
                           "spread": (max(v) - min(v)) / med,
                           "over_first": med / base}
        overlap &= min(v) <= hi0 and lo0 <= max(v)
    out["ranges_overlap"] = overlap
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gardenia_tpu_torch.tools.bench_ab")
    ap.add_argument("trees", nargs="+", help="checkouts of the repository")
    ap.add_argument("--kernels", default="pr,bfs,spmv,symgs")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    trees = [os.path.abspath(t) for t in args.trees]
    for ln in host_lines(args.device):
        print(ln, flush=True)
    for kernel in args.kernels.split(","):
        values = {t: [] for t in trees}
        for rnd in range(args.rounds):
            for t in trees:
                print(f"uptime: {_shell(['uptime'])}", flush=True)
                rec = run_bench(t, kernel, args.scale, args.device)
                values[t].append(rec["value"])
                print(json.dumps({"tree": t, "kernel": kernel, "round": rnd,
                                  "value": rec["value"], "record": rec}),
                      flush=True)
        print(json.dumps(summary(kernel, trees, values)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
