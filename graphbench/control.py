"""Readings that the limits of `correct` are set from: on many seeds, the
numbers that the port's answers give and the numbers that each kernel's
control gives in the port's place, in one process, so that the graph of a
seed is generated and built once for all of its mixes.

    python3 -m graphbench.control --config kron20 \
        --mixes pr-pull,bfs-random,tc --seeds 11,12,13 --seconds 3 \
        [--out chiprun_out/control.jsonl]

Per seed and mix: the set-up and a short window of the mix's trials
through run.py's own prepare() and drive(), the same check, then the
control's answers judged by the same check.  Prints one JSON line each,
with the check's info on both sides.  Needs a CUDA card; the benchmark's
own runs never run the control.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from graphbench import manifest


def readings(cfg: dict, mixes: list, seed: int, seconds: float, device):
    """[(mix name, program numbers, control numbers, info)] of one
    seed."""
    import torch

    from graphbench import reference
    from graphbench.run import drive, prepare

    device = torch.device(device)
    uses = [(manifest.kernel(mix["kernel"]), mix)
            for mix in map(manifest.mix, mixes)]
    edges, plans, g = prepare(cfg, seed, device, uses, {})
    runs = []
    for name, (kern, mix), plan in zip(mixes, uses, plans):
        win = drive(g, kern, mix, plan, seed, seconds, device, {})
        runs.append((name, mix, kern, plan, win["samples"],
                     len(win["times"])))
    del g
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference.clean_csr(edges.m, edges.src, edges.dst,
                              bool(cfg["symmetrize"]))
    out = []
    for name, mix, kern, plan, samples, n in runs:
        prog = kern.check(samples, ref, cfg, mix, plan)
        t = time.perf_counter()
        answers = kern.control(ref, cfg, mix, plan, samples)
        ctrl = kern.check(answers, ref, cfg, mix, plan)
        out.append((name, {k: v for k, v, _ in prog["numbers"]},
                    {k: v for k, v, _ in ctrl["numbers"]},
                    {"trials": n, "program": prog["info"],
                     "control": ctrl["info"],
                     "control_s": time.perf_counter() - t}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m graphbench.control")
    ap.add_argument("--config", required=True)
    ap.add_argument("--mixes", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("graphbench.control: no CUDA card", file=sys.stderr)
        return 3
    cfg = manifest.config(manifest.load_benchmark(), args.config)
    mixes = args.mixes.split(",")
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            for name, prog, ctrl, info in readings(cfg, mixes, seed,
                                                   args.seconds, "cuda:0"):
                line = json.dumps({"config": args.config, "mix": name,
                                   "seed": seed, "program": prog,
                                   "control": ctrl, "info": info})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
                    sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
