#!/usr/bin/env python3
"""Which calls of a benchmark trial make the host wait for the card, on a
CUDA card.

    python3 scripts/sync_audit.py [--config kron20] \
        [--mixes pr-pull,bfs-random,tc] [--seed 7] [--scale N]

The configuration's graph is generated and built through graphbench's
own prepare(); per mix, the set-up trial and the warm-ups run as the
benchmark runs them, then one trial runs under
torch.cuda.set_sync_debug_mode("warn"), which warns at every call that
synchronises with the card (a device-to-host copy, .item(), a nonzero
and the like).  Printed, a JSON line a mix: each synchronising call site
of the port (the innermost frame under gardenia_tpu_torch/) with its
count, the warning and the port's frames above it, and the host_reads the port's recorder counted in the same trial.  A
site read through utils/profiler.host_read is named by its caller and
marked (host_read).
"""

import argparse
import json
import os
import sys
import traceback
import warnings
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PORT = os.sep + "gardenia_tpu_torch" + os.sep
READER = os.path.join("utils", "profiler.py")


def port_frames(stack) -> list:
    return [f"{f.filename.split(PORT)[-1]}:{f.lineno} {f.name}"
            for f in stack if PORT in f.filename]


def audit_trial(trials, i: int) -> dict:
    """One trial under the sync debug mode: {call site: count}, their
    lines and stacks, and the recorder's host_reads."""
    import torch

    from gardenia_tpu_torch.utils import profiler
    sites, where = Counter(), {}

    def show(message, category, filename, lineno, file=None, line=None):
        frames = port_frames(traceback.extract_stack()[:-1])
        # a read through utils/profiler.host_read is its caller's
        via = bool(frames) and frames[-1].startswith(READER) and \
            frames[-1].endswith(" host_read")
        own = frames[:-1] if via else frames
        site = own[-1] if own else f"{filename}:{lineno} (no port frame)"
        if via:
            site += " (host_read)"
        sites[site] += 1
        where.setdefault(site, {"message": str(message)[:160],
                                "stack": frames[-6:]})

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiler.recording():
                trials(i)
                rec = profiler.take()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return {"syncs": dict(sites), "sites": where,
            "host_reads": rec["counters"].get("host_reads", 0)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scripts/sync_audit.py")
    ap.add_argument("--config", default="kron20")
    ap.add_argument("--mixes", default="pr-pull,bfs-random,tc")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--scale", type=int, default=None)
    args = ap.parse_args(argv)
    import torch

    from graphbench import manifest
    from graphbench.run import prepare, sync
    if not torch.cuda.is_available():
        print("sync_audit: no CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    cfg = dict(manifest.config(manifest.load_benchmark(), args.config))
    if args.scale is not None:
        cfg["scale"] = args.scale
    mixes = args.mixes.split(",")
    uses = [(manifest.kernel(manifest.mix(m)["kernel"]), manifest.mix(m))
            for m in mixes]
    _, plans, g = prepare(cfg, args.seed, device, uses, {})
    for name, (kern, mix), plan in zip(mixes, uses, plans):
        trials = kern.Trials(g, device, mix, plan)
        trials.first()
        for k in range(trials.warmups):
            trials.warm(k)
        sync(device)
        out = audit_trial(trials, 0)
        print(json.dumps({"config": args.config, "mix": name,
                          "scale": cfg["scale"], **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
