#!/usr/bin/env python3
"""Probe of kernel Q1 (csrc/kcl_local_count.cu, kCL's local-graph clique
count) on a CUDA card: where its time goes, by degree class.

    python3 scripts/probe_q1.py [--scale 20] [--k 4] [--reps 5]
    python3 scripts/probe_q1.py --source OLD.cu     # another form of Q1
    python3 scripts/probe_q1.py --cut 0 --cut 512 --set CTA_THREADS=256

Prints nvidia-smi's name and power limit, then builds three copies of the
kernel's source (the shipped one, or --source: e.g. the first form's,
`git show 7384147:gardenia_tpu_torch/csrc/kcl_local_count.cu`), each
alone under the build directory:
  full    the source as it is;
  build   the count replaced by one popcount a local row (what k = 3
          costs): the local graph is built, its cliques are not counted;
  stream  as build, and every membership test replaced by one that always
          misses but still reads the id: the rows are staged and scanned,
          nothing is searched or set.
On the `g.oriented()` DAG of the bench's R-MAT graph it launches each copy
once per degree class (out-degree up to 32, 64, 128, 256, 512, 1024),
timed by CUDA events, and prints per class: the three times and the split
they give (stream; build = build - stream: the membership tests and the
bits they set; count = full - build), and the whole.  The full copy's
per-vertex counts are held to the shipped kernel's (ops/kcl_count).

A source of the first form (class launches, vertex lists in ascending
out-degree) is launched as its wrapper launched it; one of the current
form (a persistent CTA grid that takes vertices from a counter, largest
first) on each class's run of the descending order, and then over the
wrapper's launch plan as it is and, for each --cut D, with the hubs that
it launches apart taken above out-degree D (0: one CTA run; each run's
shared memory sized to its own widest vertex).  Each --set rewrites
`constexpr int NAME = ...;` lines of the source and probes that copy
too, after the source as it is.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CLASSES = (32, 64, 128, 256, 512, 1024)
# (old text, new text) pairs: each variant applies the edits of its names;
# an edit must match in the source at least once under one of its forms
# (the first form of the kernel or the current one)
EDITS = {
    "skip_count": (
        # the first form
        ("unsigned long long s = lane < d ? count_word<K - 2>(A[lane], A) "
         ": 0ull;",
         "unsigned long long s = lane < d ? __popc(A[lane]) : 0ull;"),
        ("s += count_words<K - 2>(cand, A, W, lane);",
         "s += __popc(cand);"),
        # the current form
        ("const unsigned long long s = count_local<K>(A, d, W);",
         "const unsigned long long s = count_local<3>(A, d, W);"),
        ("s += count_word<K - 2>(A[i], A);", "s += popcnt(A[i]);"),
    ),
    "miss": (
        ("const int j = find(ids, d, y);",
         "const int j = y == -7 ? 0 : -1;"),
        ("in_filter(filter, fbits, y[i])", "y[i] == -7"),
    ),
}
VARIANTS = {"full": (), "build": ("skip_count",),
            "stream": ("skip_count", "miss")}


def variant_text(text: str, edits) -> str:
    for name in edits:
        hit = False
        for old, new in EDITS[name]:
            if old in text:
                text, hit = text.replace(old, new), True
        if not hit:
            sys.exit(f"probe_q1: no form of the edit {name!r} matches the "
                     "source")
    return text


def build_copies(text: str) -> dict:
    """{variant: ctypes library} for the source `text`, built in
    parallel."""
    from gardenia_tpu_torch.ops import _build
    out = os.path.join(_build.BUILD_DIR, "probe_q1")
    os.makedirs(out, exist_ok=True)

    def one(name):
        body = variant_text(text, VARIANTS[name])
        # a path of its own for each text: dlopen keeps the first library
        # it loaded from a path
        tag = hashlib.sha1(body.encode()).hexdigest()[:12]
        src = os.path.join(out, f"q1_{name}_{tag}.cu")
        with open(src, "w") as f:
            f.write(body)
        so = src[:-3] + ".so"
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-o", so, src], check=True)
        lib = ctypes.CDLL(so)
        vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        persistent = hasattr(lib, "gdn_kcl_shared_bytes")
        lib.gdn_kcl_local_count.argtypes = (
            [vp, vp, vp, ll, vp, vp, ci, ci, vp] if persistent
            else [vp, vp, vp, ll, vp, ci, ci, vp])
        lib.gdn_kcl_local_count.restype = ci
        if persistent:
            lib.gdn_kcl_cta_info.argtypes = [ci, ctypes.POINTER(ci),
                                             ctypes.POINTER(ci)]
            lib.gdn_kcl_cta_info.restype = ci
        lib.persistent = persistent
        return lib
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        return dict(zip(VARIANTS, pool.map(one, VARIANTS)))


def class_runs(ldag, k: int, persistent: bool) -> dict:
    """{class: (vertex list, dmax)}: the launched vertices of each degree
    class, in ascending out-degree with the class's top as dmax (as the
    first form launched them) or in the descending order that the
    persistent grid takes with the widest as dmax."""
    deg = (ldag.rowptr[1:] - ldag.rowptr[:-1]).cpu().numpy()
    out, lower = {}, k - 2
    for c in CLASSES:
        sel = np.flatnonzero((deg > lower) & (deg <= c))
        lower = c
        if sel.size:
            sel = sel[np.argsort(deg[sel] if not persistent else -deg[sel],
                                 kind="stable")]
            # the first form's wrapper sized a launch to its class's top
            out[c] = (torch.from_numpy(sel.astype(np.int32)).to(
                ldag.rowptr.device), int(deg[sel].max()) if persistent
                else c)
    return out


def launch(lib, ldag, verts, dmax: int, k: int, cnt, counter) -> None:
    from gardenia_tpu_torch.ops import _build
    stream = torch.cuda.current_stream().cuda_stream
    args = [ldag.rowptr.data_ptr(), ldag.colidx.data_ptr(),
            verts.data_ptr(), verts.numel(), cnt.data_ptr()]
    if lib.persistent:
        counter.zero_()
        args.append(counter.data_ptr())
    _build.check(lib.gdn_kcl_local_count(*args, k, dmax, stream),
                 "probe_q1 copy")


def event_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def plan_runs(ldag, k: int, cut: int = None):
    """[(vertex list, dmax)]: the runs of the wrapper's launch plan, with
    its hubs taken above out-degree `cut` when given (0: none apart)."""
    from gardenia_tpu_torch.ops import kcl_count
    keep = kcl_count.HUB_DEGREE
    try:
        if cut is not None:
            kcl_count.HUB_DEGREE = cut
        plan = kcl_count.launch_plan(ldag, k)
    finally:
        kcl_count.HUB_DEGREE = keep
    return [(ldag.order[first:end], dmax) for first, end, dmax in plan]


def set_constants(text: str, values: dict) -> str:
    """The source with `constexpr int NAME = ...;` set to each value."""
    for name, value in values.items():
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(f"constexpr int {name} = ")]
        if len(lines) != 1:
            sys.exit(f"probe_q1: constexpr int {name} not once in the source")
        text = text.replace(lines[0], f"constexpr int {name} = {value};")
    return text


def split(ldag, k: int, text: str = None, reps: int = 5,
          cuts=()) -> dict:
    """Per degree class, the three copies' ms and the split; the full
    copy's counts held to the shipped kernel's (exits on a difference);
    for the current form also the full copy over the wrapper's launch
    plan, as it is and with its hubs taken above each of `cuts`."""
    from gardenia_tpu_torch.ops import _build, kcl_count
    if text is None:
        with open(os.path.join(_build.CSRC, "kcl_local_count.cu")) as f:
            text = f.read()
    libs = build_copies(text)
    persistent = libs["full"].persistent
    runs = class_runs(ldag, k, persistent)
    dev = ldag.rowptr.device
    m = ldag.rowptr.numel() - 1
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    want = kcl_count.local_count(ldag, k)
    got = torch.zeros(m, dtype=torch.int64, device=dev)
    for verts, dmax in runs.values():
        launch(libs["full"], ldag, verts, dmax, k, got, counter)
    bad = int((got != want).sum())
    if bad:
        sys.exit(f"probe_q1: the full copy differs from the shipped kernel "
                 f"at {bad} vertices")
    scratch = torch.zeros(m, dtype=torch.int64, device=dev)
    table = {}
    for c, (verts, dmax) in runs.items():
        t = {name: event_ms(lambda lib=lib: launch(
            lib, ldag, verts, dmax, k, scratch, counter), reps)
            for name, lib in libs.items()}
        table[c] = {"vertices": verts.numel(), "dmax": dmax, **t,
                    "split_stream": t["stream"],
                    "split_build": t["build"] - t["stream"],
                    "split_count": t["full"] - t["build"]}
    whole = {name: sum(row[name] for row in table.values())
             for name in VARIANTS}
    plans, resources = {}, None
    if persistent:
        regs, per_sm = ctypes.c_int(), ctypes.c_int()
        widest = int(ldag.degrees[0])
        _build.check(libs["full"].gdn_kcl_cta_info(
            widest, ctypes.byref(regs), ctypes.byref(per_sm)), "cta_info")
        resources = {"dmax": widest, "registers": regs.value,
                     "ctas_per_sm": per_sm.value}
        for cut in (None, *cuts):
            prs = plan_runs(ldag, k, cut)
            plans["plan" if cut is None else f"hubs above {cut}"] = \
                event_ms(lambda prs=prs: [launch(
                    libs["full"], ldag, verts, dmax, k, scratch, counter)
                    for verts, dmax in prs], reps)
    return {"form": "persistent" if persistent else "class launches",
            "k": k, "classes": table, "whole": whole, "plans": plans,
            "cta_resources": resources}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--source", default=None)
    ap.add_argument("--cut", type=int, action="append", default=[],
                    help="also time the launch plan with its hubs launched "
                         "apart above this out-degree, 0 for none "
                         "(repeatable)")
    ap.add_argument("--set", action="append", default=[],
                    help="NAME=V[,NAME=V]: also probe a copy with these "
                         "constexpr ints of the source rewritten "
                         "(repeatable)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_q1: needs a CUDA card")
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.mining import kcl
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(gpu, flush=True)
    t0 = time.perf_counter()
    g = bench.get_graph(args.scale)
    ldag = kcl.local_dag(g, torch.device("cuda"))
    print(f"rmat{args.scale}: DAG of {ldag.colidx.numel()} arcs, widest "
          f"out-degree {ldag.max_degree} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if args.source:
        with open(args.source) as f:
            text = f.read()
    else:
        from gardenia_tpu_torch.ops import _build
        with open(os.path.join(_build.CSRC, "kcl_local_count.cu")) as f:
            text = f.read()
    configs = [{}] + [dict(kv.split("=") for kv in arg.split(","))
                      for arg in args.set]
    print(f"gpu: {gpu}")
    for values in configs:
        res = split(ldag, args.k, set_constants(text, values), args.reps,
                    args.cut)
        label = ",".join(f"{n}={v}" for n, v in values.items()) or "as is"
        for c, row in res["classes"].items():
            print(f"[{label}] class d <= {c}: " + json.dumps(row))
        print(f"[{label}] whole: {json.dumps(res['whole'])}; plans: "
              f"{json.dumps(res['plans'])}; CTA shape at k = 4: "
              f"{json.dumps(res['cta_resources'])}", flush=True)
        print(json.dumps({"source": args.source or "shipped",
                          "constants": values, **res}))


if __name__ == "__main__":
    main()
