#!/usr/bin/env python3
"""Probe of the batched K1 (csrc/dense_panel_matmul_tc.cu) on a CUDA card:
what its skip of empty panel tiles pays, and how many tiles are empty.

    python3 scripts/probe_k1_batched.py [--scale 20] [--sources 128]

Builds, beside the shipped kernel library, a copy of the kernel's source in
which the warp votes on the loaded panel words are replaced by `true` (every
tile is multiplied), checks that both give the same product, and times one
sweep over the R-MAT graph's panel arrays with each, in turns (skip, no
skip, no skip, skip) by CUDA events, with an f32 and with a 0/1 bf16
operand.  Then it counts, on the card, the share of 16 x 16, 32 x 16 and
128 x 16 panel tiles that hold an edge.  Prints nvidia-smi's name and power
limit last.  The copy is built in a temporary directory and not kept.
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--sources", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_k1_batched: needs a CUDA card")
    from chip_smoke import cuda_ms
    from gardenia_tpu_torch.bench import get_graph
    from gardenia_tpu_torch.core import views
    from gardenia_tpu_torch.ops import _build, panel

    source = os.path.join(_build.CSRC, "dense_panel_matmul_tc.cu")
    with open(source) as f:
        text = f.read()
    always, n = re.subn(r"const bool (nz[01]) =\s*__any_sync\([^;]*;",
                        r"const bool \1 = true;", text)
    if n != 2:
        sys.exit("probe_k1_batched: the kernel's two votes were not found")
    tmp = tempfile.mkdtemp()
    with open(os.path.join(tmp, "noskip.cu"), "w") as f:
        f.write(always)
    lib = os.path.join(tmp, "noskip.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    lib, os.path.join(tmp, "noskip.cu")], check=True)
    noskip = ctypes.CDLL(lib)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    noskip.gdn_dense_panel_matmul_tc.argtypes = [
        vp, ci, vp, vp, ci, vp, ctypes.c_longlong, ci, ci, vp]

    dev = torch.device("cuda")
    g = get_graph(args.scale)
    _, hyb, _ = views.relabeled_hybrid(g, dev)
    S = args.sources
    qx = (g.n + 127) // 128
    xf = torch.rand((qx, 128, S), device=dev)
    xm = (xf < 0.3).to(torch.bfloat16)

    def sweep(x):
        return lambda: [panel.dense_panel_matmul(p.panel, p.src, x, S)
                        for p in hyb.dense]

    def sweep_noskip(x):
        def go():
            outs = []
            for p in hyb.dense:
                R, W = p.src.shape
                out = torch.empty((R, 128, S), dtype=torch.float32,
                                  device=dev)
                code = noskip.gdn_dense_panel_matmul_tc(
                    p.panel.data_ptr(), 0, p.src.data_ptr(), x.data_ptr(),
                    1 if x.dtype == torch.bfloat16 else 2, out.data_ptr(), R,
                    W, S, torch.cuda.current_stream().cuda_stream)
                if code:
                    sys.exit(f"probe_k1_batched: CUDA error {code}")
                outs.append(out)
            return outs
        return go

    for x in (xf, xm):
        for a, b in zip(sweep(x)(), sweep_noskip(x)()):
            rel = float((a - b).abs().max()) / max(1e-30, float(a.abs().max()))
            if not rel < 1e-5:
                sys.exit(f"probe_k1_batched: the copies disagree ({rel})")
    for name, x in (("f32", xf), ("bf16 0/1", xm)):
        fns = {"skip": sweep(x), "no skip": sweep_noskip(x)}
        for which in ("skip", "no skip", "no skip", "skip"):
            print(f"{name} operand, {which}: "
                  f"{cuda_ms(fns[which], reps=5, warmup=1)} ms a sweep",
                  flush=True)
    tiles = {"16x16": [0, 0], "32x16": [0, 0], "128x16": [0, 0]}
    for p in hyb.dense:
        R, W = p.src.shape
        t16 = (p.panel != 0).view(R, 8, 16, W * 8, 16).any(dim=4).any(dim=2)
        for key, t in (("16x16", t16),
                       ("32x16", t16.view(R, 4, 2, W * 8).any(dim=2)),
                       ("128x16", t16.any(dim=1))):
            tiles[key][0] += int(t.sum())
            tiles[key][1] += t.numel()
    for key, (nz, total) in tiles.items():
        print(f"{key} tiles that hold an edge: {nz} of {total} "
              f"({nz / total})")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
