#!/usr/bin/env python3
"""Probe of kernel V1 (csrc/vc_core_firstfit.cu, VC's core first-fit) on a
CUDA card.

    python3 scripts/probe_v1.py --bring-up      # exactness only, R-MAT-16
    python3 scripts/probe_v1.py [--scale 20] [--repeats 20]

Prints nvidia-smi's name and power limit, then holds V1 to its plain loop,
exactly, on chip_smoke.py's hand-made cases and on the core pass of
R-MAT-16's solve (the whole graph), with --repeats more launches on that
core, all equal; --bring-up stops there.

Then it builds the VC bench's core: the core pass of the second
`vc_solver` of the bench's R-MAT graph (the first finds the palette the
graph then remembers), holds V1 to its plain loop there too and prints
each core's depth D (the levels of the order's DAG: the longest chain of
earlier neighbours) and the sizes of its levels.  Last, the grid sweep:
for every (warps an SM, backoff ns) of SWEEP, a copy of the kernel's
source with its WARPS_PER_SM constant rewritten and, for a backoff, a
`__nanosleep` put between a lane's polls, built alone under the build
directory; each copy's V1 at each core, exact and repeated, and on a chain
of that core's D positions (the floor of D hand-overs), all by CUDA
events.  The shipped source is the copy at (4, 0).
"""

import argparse
import ctypes
import functools
import itertools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SWEEP_WARPS_PER_SM = (2, 4, 8, 16)
SWEEP_BACKOFF_NS = (0, 64, 256)
GRID_LINE = "constexpr int WARPS_PER_SM = 4;"
SPIN_LINE = "if (++spins > SPIN_LIMIT) __trap();"


def build_copy(wps: int, ns: int) -> ctypes.CDLL:
    """The kernel's source at `wps` warps an SM and `ns` ns between polls,
    built alone; its C entry is the shipped one's."""
    from gardenia_tpu_torch.ops import _build
    text = open(os.path.join(_build.CSRC, "vc_core_firstfit.cu")).read()
    for line in (GRID_LINE, SPIN_LINE):
        if text.count(line) != 1:
            sys.exit(f"probe_v1: {line!r} not once in the kernel's source")
    text = text.replace(GRID_LINE, f"constexpr int WARPS_PER_SM = {wps};")
    if ns:
        text = text.replace(SPIN_LINE, f"{SPIN_LINE} __nanosleep({ns});")
    out = os.path.join(_build.BUILD_DIR, "probe_v1")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, f"v1_{wps}_{ns}.cu")
    with open(src, "w") as f:
        f.write(text)
    so = src[:-3] + ".so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    so, src], check=True)
    lib = ctypes.CDLL(so)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.gdn_vc_core_firstfit.argtypes = [vp] * 5 + [ci, ci, vp]
    lib.gdn_vc_core_firstfit.restype = ci
    return lib


def launch(lib, forb, rowptr, col):
    """The copy's V1 on (forb, rowptr, col), as ops/vc_core launches it."""
    from gardenia_tpu_torch.ops import _build, vc_core
    K, C = forb.shape
    chosen = torch.full((K,), vc_core.PENDING, dtype=torch.int32,
                        device=forb.device)
    counter = torch.zeros(1, dtype=torch.int32, device=forb.device)
    _build.check(lib.gdn_vc_core_firstfit(
        forb.data_ptr(), rowptr.data_ptr(), col.data_ptr(), chosen.data_ptr(),
        counter.data_ptr(), K, C, torch.cuda.current_stream().cuda_stream),
        "probe_v1 copy")
    return chosen


def capture_core(graph, solves: int, dev):
    """The inputs of the first core pass of the last of `solves` solves of
    `graph`."""
    from gardenia_tpu_torch.ops import vc_core
    from gardenia_tpu_torch.solvers import vc
    real = vc_core.vc_core_firstfit
    for _ in range(solves):
        seen = []

        def spy(*inputs):
            if not seen:
                seen.append(inputs)
            return real(*inputs)
        vc_core.vc_core_firstfit = spy
        try:
            vc.vc_solver(graph, device=dev)
        finally:
            vc_core.vc_core_firstfit = real
    return seen[0]


def hold(label, inputs, want=None, repeats: int = 0, v1=None):
    """V1 (the shipped one, or `v1`) against the plain loop's result
    (`want`, computed when not given), and `repeats` more launches against
    it; exits on a difference.  Returns the plain loop's result."""
    from gardenia_tpu_torch.ops import vc_core
    v1 = v1 or vc_core.vc_core_firstfit
    got = v1(*inputs)
    if want is None:
        want = vc_core.vc_core_firstfit_plain(*inputs)
    bad = int((got != want).sum())
    differ = sum(not torch.equal(v1(*inputs), want) for _ in range(repeats))
    forb = inputs[0]
    print(f"V1 {label}: K {forb.shape[0]} C {forb.shape[1]}, "
          f"{inputs[2].numel()} lower edges, {int((got < 0).sum())} "
          f"saturated; {bad} entries differ from the plain loop's"
          + (f", {differ} of {repeats} repeats differ" if repeats else ""),
          flush=True)
    if bad or differ:
        sys.exit(f"probe_v1: V1 is not exact on {label}")
    return want


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bring-up", action="store_true")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_v1: needs a CUDA card")
    from chip_smoke import cuda_ms, v1_chain, v1_hand_cases
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.core.generate import generate_graph
    from gardenia_tpu_torch.ops import _build, vc_core
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    _build.lib()
    for label, *inputs in v1_hand_cases(dev):
        hold(label, inputs)
    g16 = generate_graph("rmat", scale=16, degree=16, symmetrize=True)
    cores = {"rmat16": capture_core(g16, 1, dev)}
    want = {"rmat16": hold("rmat16 core", cores["rmat16"],
                           repeats=args.repeats)}
    if args.bring_up:
        return
    label = f"rmat{args.scale}"
    cores[label] = capture_core(bench.get_graph(args.scale), 2, dev)
    want[label] = hold(f"{label} core at the bench's palette", cores[label],
                       repeats=args.repeats)
    depth = {}
    for name, (forb, rowptr, col) in cores.items():
        sizes = np.bincount(vc_core.core_levels(rowptr, col))[1:]
        depth[name] = len(sizes)
        print(f"{name} core: K {forb.shape[0]} C {forb.shape[1]}, "
              f"{col.numel()} lower edges, depth {len(sizes)}, widest level "
              f"{sizes.max()}, median level {int(np.median(sizes))}, levels "
              f"of at most 32: {int((sizes <= 32).sum())}, the first ten "
              f"{sizes[:10].tolist()}", flush=True)
    points = list(itertools.product(SWEEP_WARPS_PER_SM, SWEEP_BACKOFF_NS))
    with ThreadPoolExecutor(len(points)) as pool:
        libs = dict(zip(points, pool.map(lambda p: build_copy(*p), points)))
    rows = []
    for (wps, ns), lib in libs.items():
        row = {"warps_per_sm": wps, "backoff_ns": ns}
        v1 = functools.partial(launch, lib)
        for name, inputs in cores.items():
            hold(f"{name} core, {wps} warps an SM, backoff {ns} ns",
                 inputs, want[name], repeats=3, v1=v1)
            chain = v1_chain(depth[name], inputs[0].shape[1], dev)
            row[f"{name}_ms"] = cuda_ms(lambda: v1(*inputs), reps=5)
            row[f"{name}_chain_ms"] = cuda_ms(lambda: v1(*chain), reps=5)
        rows.append(row)
        print(json.dumps(row), flush=True)
    best = min(rows, key=lambda r: r[f"{label}_ms"])
    print(f"fastest at the {label} core: {json.dumps(best)}; shipped: 4 "
          f"warps an SM, no backoff; depth {json.dumps(depth)}")


if __name__ == "__main__":
    main()
