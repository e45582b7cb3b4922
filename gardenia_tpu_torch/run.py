"""Run the whole benchmark surface of the port — the twin of the repo's
run.py (the reference's `run` script: every kernel over the dataset list,
reference run:5-100), driving `python -m gardenia_tpu_torch.cli`.

    python -m gardenia_tpu_torch.run [--datasets d1,d2] [--kernels k1,k2]
                                     [--device cuda|cpu] [--quick]
                                     [--reference DIR]

Defaults to the fixture dataset of run.py, read from the reference
project's checkout that --reference (or $GARDENIA_REFERENCE) names, and
.mtx files in ./datasets/ when present.  Without --quick or --datasets it
adds R-MAT rows through the CLI's own generator: `rmat 16 1` for
SCALE16_KERNELS and `rmat 12` with each kernel's positional tail for
MID12_KERNELS (run.py:32-38).  A fixture with no reference checkout
named, or a dataset file that is absent, is printed as skipped and
counted apart from the passes and failures.  Exits 1 when a run fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

# the fixtures of run.py, as paths in the reference project's checkout
FIXTURES = [
    ("mtx", os.path.join("datasets", "chesapeake.mtx"), "1"),
]

ANALYTICS = ["bfs", "sssp", "pr", "cc", "bc", "vc", "spmv", "symgs",
             "tc", "scc", "mst", "sgd"]
MINING = ["kcl", "motif", "sgl", "fsm"]
# kernels whose serial oracles stay tractable at scale 16 (run.py:32-34)
SCALE16_KERNELS = {"bfs", "sssp", "pr", "cc", "vc", "spmv", "tc",
                   "bc", "scc", "symgs", "mst", "sgd"}
# mining kernels on R-MAT-12, under the CLI's serial-oracle gates; the
# values are the positional tail after <filetype> <scale> (kcl: sym + k;
# fsm: minsup + max-size, run.py:38)
MID12_KERNELS = {"kcl": ("1", "4"), "fsm": ("2", "2")}


def targets(kernel: str, datasets, rmat: bool):
    """[(filetype, path or scale, positional tail)] of one kernel."""
    out = [(ft, path, (sym,)) for ft, path, sym in datasets]
    if rmat and kernel in SCALE16_KERNELS:
        out.append(("rmat", "16", ("1",)))
    if rmat and kernel in MID12_KERNELS:
        out.append(("rmat", "12", MID12_KERNELS[kernel]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gardenia_tpu_torch.run")
    ap.add_argument("--kernels", default=",".join(ANALYTICS + MINING))
    ap.add_argument("--datasets", default=None,
                    help="comma-separated graph paths (default: fixtures)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--quick", action="store_true",
                    help="fixture datasets only (skip the R-MAT rows)")
    ap.add_argument("--reference",
                    default=os.environ.get("GARDENIA_REFERENCE"),
                    help="the reference project's checkout, which holds "
                         "the fixtures (default: $GARDENIA_REFERENCE)")
    args = ap.parse_args(argv)

    if args.datasets:
        datasets = [("mtx", p, "1") for p in args.datasets.split(",")]
    else:
        # without a reference checkout a fixture is a row with no file
        datasets = [(ft, os.path.join(args.reference, rel) if args.reference
                     else None, sym) for ft, rel, sym in FIXTURES]
        if os.path.isdir("datasets"):
            datasets += [("mtx", os.path.join("datasets", f), "1")
                         for f in sorted(os.listdir("datasets"))
                         if f.endswith(".mtx")]
    rmat = not args.quick and not args.datasets

    passed = failed = skipped = 0
    for kernel in args.kernels.split(","):
        for ft, path, tail in targets(kernel, datasets, rmat):
            if path is None:
                skipped += 1
                print(f"[SKIP] {kernel:6s} {'fixture':22s} (no reference "
                      "checkout: give --reference or $GARDENIA_REFERENCE)",
                      flush=True)
                continue
            name = f"rmat{path}" if ft == "rmat" else os.path.basename(path)
            if ft != "rmat" and not os.path.exists(path):
                skipped += 1
                print(f"[SKIP] {kernel:6s} {name:22s} (no file {path})",
                      flush=True)
                continue
            cmd = [sys.executable, "-u", "-m", "gardenia_tpu_torch.cli",
                   kernel, ft, path, *tail, f"--device={args.device}"]
            t0 = time.time()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            ok = proc.returncode == 0 and "Correct" in proc.stdout.split()
            passed += ok
            failed += not ok
            runtime = next((ln.strip() for ln in proc.stdout.splitlines()
                            if "runtime [" in ln), "")
            print(f"[{'PASS' if ok else 'FAIL'}] {kernel:6s} {name:22s} "
                  f"{runtime}  ({time.time() - t0:.1f}s)", flush=True)
            if not ok and proc.stderr:
                print("  stderr:", proc.stderr.strip().splitlines()[-1])
    print(f"\n{passed} passed, {failed} failed, {skipped} skipped")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
