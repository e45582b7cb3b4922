#!/usr/bin/env python3
"""Probe of the batched K1 (csrc/dense_panel_matmul_tc.cu) on a CUDA card.

    python3 scripts/probe_k1_batched.py --bring-up      # edge cases only
    python3 scripts/probe_k1_batched.py [--scale 20] [--sources 128] \\
        [--old-source PATH]

Prints the kernel's resources (registers a thread, spilled bytes, shared
memory a CTA, stages, CTAs an SM) for every panel and operand type, then
holds it to the plain version on small hand-made panel arrays (one slot of
one block, one nonzero cell, a dense block, the widest slot with one cell a
block, an all-zero slot, bf16 panels) at S = 8, 9, 16, 100, 128, 136, 256
with a random f32 and a random bf16 operand; --bring-up stops there.

Then, on the R-MAT graph's panel arrays at S = --sources, it times one
sweep (every panel array once) by CUDA events, in turns, of: the kernel as
shipped (every k16 step multiplied); the isolating copies of ISOLATE, each
the shipped source with one textual change that keeps its staging (TMA
stages, mbarriers, the A conversion) and cuts its wgmmas, so that their
times part the sweep into tensor work and the rest (their results are not
K1's and are not checked); and, with --old-source, PR 6's mma.sync kernel
(C entry (panel, panel dtype, src, x3d, x dtype, out, R, W, S, stream)),
`git show f8d2cc3:gardenia_tpu_torch/csrc/dense_panel_matmul_tc.cu`, held
to the shipped kernel.  The f32 operand's sweep includes its split into
bf16 terms; the split alone is timed too.  Last, the share of 16 x 16 and
64 x 16 panel tiles that hold an edge.  Copies are built in a temporary
directory and not kept.  Prints nvidia-smi's name and power limit first.
"""

import argparse
import ctypes
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REL_LIMIT = {"f32": 1e-5, "bf16": 1e-4}
# copy name -> (text of the shipped source, its replacement): the products
# of a block's k16 steps for the first term only (the f32 route's wgmmas a
# third, the bf16 route's unchanged), and for none
ISOLATE = {"products of 1 term": ("term < TERMS; ++term)",
                                  "term < 1; ++term)"),
           "no products": ("term < TERMS; ++term)", "term < 0; ++term)")}


def build_copy(source: str, change=None) -> ctypes.CDLL:
    """source built alone into a temporary library; `change` (old, new)
    rewrites its one occurrence of old first."""
    from gardenia_tpu_torch.ops import _build
    tmp = tempfile.mkdtemp()
    if change is not None:
        text = open(source).read()
        if text.count(change[0]) != 1:
            sys.exit(f"probe_k1_batched: {change[0]!r} not once in {source}")
        source = os.path.join(tmp, "copy.cu")
        with open(source, "w") as f:
            f.write(text.replace(*change))
    lib = os.path.join(tmp, "copy.so")
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    lib, source], check=True)
    return ctypes.CDLL(lib)


def edge_cases(dev) -> int:
    """Hand-made arrays against the plain version; returns the failures."""
    from gardenia_tpu_torch.ops import panel
    rng = np.random.default_rng(5)

    def arr(R, W, fill, dtype=np.int8):
        pn = np.zeros((R, 128, W * 128), np.float32)
        fill(pn)
        src = rng.integers(0, 6, (R, W)).astype(np.int32)
        t = torch.from_numpy(pn.astype(dtype) if dtype == np.int8 else pn)
        if dtype != np.int8:
            t = t.to(torch.bfloat16)
        return t.to(dev), torch.from_numpy(src).to(dev)

    def one_cell(pn):
        pn[0, 5, 17] = 1

    def one_cell_a_block(pn):
        for w in range(pn.shape[2] // 128):
            pn[:, rng.integers(0, 128), w * 128 + rng.integers(0, 128)] = 1

    def sparse(pn):
        pn[:] = (rng.random(pn.shape) < 0.02) * rng.integers(-3, 4, pn.shape)

    def zero_slot(pn):
        sparse(pn)
        pn[1] = 0

    cases = [("R=1 W=1 one cell", arr(1, 1, one_cell)),
             ("R=1 W=1 dense", arr(1, 1, lambda pn: pn.__setitem__(
                 slice(None), rng.integers(-127, 128, pn.shape)))),
             ("W=2 sparse", arr(3, 2, sparse)),
             ("all-zero slot", arr(3, 4, zero_slot)),
             ("W=32 one cell a block", arr(2, 32, one_cell_a_block)),
             ("W=8 stages wrap", arr(5, 8, sparse)),
             ("bf16 panel", arr(2, 4, lambda pn: pn.__setitem__(
                 slice(None), (rng.random(pn.shape) < 0.05)
                 * rng.integers(128, 256, pn.shape)), np.float32))]
    bad = 0
    for S in (8, 9, 16, 100, 128, 136, 256):
        xf = torch.from_numpy(rng.random((6, 128, S)).astype(np.float32)) \
            .to(dev)
        for label, (pn, src) in cases:
            out = []
            for name, x in (("f32", xf), ("bf16", xf.to(torch.bfloat16))):
                y = panel.dense_panel_matmul(pn, src, x, S)
                want = panel.dense_panel_matmul_plain(pn, src, x, S)
                torch.cuda.synchronize()
                err = float((y - want).abs().max())
                rel = err / max(1e-30, float(want.abs().max()))
                ok = np.isfinite(rel) and rel < REL_LIMIT[name]
                bad += not ok
                out.append(f"{name} rel {rel:.2e}{'' if ok else ' BAD'}")
            print(f"S={S:3d} {label}: " + ", ".join(out), flush=True)
    return bad


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--sources", type=int, default=128)
    ap.add_argument("--old-source", default=None)
    ap.add_argument("--bring-up", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("probe_k1_batched: needs a CUDA card")
    from chip_smoke import cuda_ms
    from gardenia_tpu_torch.bench import get_graph
    from gardenia_tpu_torch.core import views
    from gardenia_tpu_torch.ops import _build, panel

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    _build.lib()
    for pd in (torch.int8, torch.bfloat16):
        for xd in (torch.bfloat16, torch.float32):
            print(f"resources, {pd} panels, {xd} operand: "
                  f"{panel.tc_kernel_info(pd, xd)}", flush=True)
    dev = torch.device("cuda")
    bad = edge_cases(dev)
    print(f"edge cases: {bad} over the limit", flush=True)
    if bad:
        sys.exit(1)
    if args.bring_up:
        return

    source = os.path.join(_build.CSRC, "dense_panel_matmul_tc.cu")
    copies = {k: build_copy(source, change) for k, change in ISOLATE.items()}
    old = build_copy(args.old_source) if args.old_source else None
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for lib in copies.values():
        lib.gdn_dense_panel_matmul_tc.argtypes = [
            vp, ci, vp, vp, ci, vp, ll, ci, ci, ll, vp]
    if old:
        old.gdn_dense_panel_matmul_tc.argtypes = [
            vp, ci, vp, vp, ci, vp, ll, ci, ci, vp]

    g = get_graph(args.scale)
    _, hyb, _ = views.relabeled_hybrid(g, dev)
    S = args.sources
    qx = (g.n + 127) // 128
    xf = torch.rand((qx, 128, S), device=dev)
    xm = (xf < 0.3).to(torch.bfloat16)
    Sp = panel.padded_columns(S)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def shipped(x):
        return lambda: panel.dense_panel_matmul_arrays(
            [(p.panel, p.src) for p in hyb.dense], x, S)

    def copy_new(lib, x):
        def go():
            xt = panel.tc_operand(x)
            outs = []
            for p in hyb.dense:
                R, W = p.src.shape
                out = torch.empty((R, 128, Sp), device=dev)
                code = lib.gdn_dense_panel_matmul_tc(
                    p.panel.data_ptr(), 0, p.src.data_ptr(), xt.data_ptr(),
                    xt.shape[0], out.data_ptr(), R, W, Sp, qx * 128,
                    stream())
                if code:
                    sys.exit(f"probe_k1_batched: CUDA error {code}")
                outs.append(out[..., :S])
            return outs
        return go

    def copy_old(x):
        def go():
            outs = []
            for p in hyb.dense:
                R, W = p.src.shape
                out = torch.empty((R, 128, S), device=dev)
                code = old.gdn_dense_panel_matmul_tc(
                    p.panel.data_ptr(), 0, p.src.data_ptr(), x.data_ptr(),
                    1 if x.dtype == torch.bfloat16 else 2, out.data_ptr(), R,
                    W, S, stream())
                if code:
                    sys.exit(f"probe_k1_batched: CUDA error {code}")
                outs.append(out)
            return outs
        return go

    for name, x in (("f32", xf), ("bf16 0/1", xm)):
        fns = {"shipped": shipped(x)}
        fns.update({k: copy_new(lib, x) for k, lib in copies.items()})
        if old:
            fns["old source"] = copy_old(x)
        want = fns["shipped"]()
        for which, fn in fns.items():
            if which in ISOLATE:
                continue
            rel = max(float((a - b).abs().max()) / max(1e-30, float(
                a.abs().max())) for a, b in zip(want, fn()))
            print(f"{name} operand, {which} vs shipped: rel {rel:.3e}",
                  flush=True)
            if not rel < 1e-5:
                sys.exit(f"probe_k1_batched: {which} disagrees")
        del want
        order = list(fns) + list(fns)[::-1]
        times = {k: [] for k in fns}
        for which in order:
            times[which].append(cuda_ms(fns[which], reps=5, warmup=1))
        for which, ts in times.items():
            print(f"{name} operand, {which}: {sum(ts) / len(ts)} ms a sweep "
                  f"(runs {ts})", flush=True)
    print(f"the split of the f32 operand alone: "
          f"{cuda_ms(lambda: panel.split_operand(xf), reps=5)} ms", flush=True)
    tiles = {"16x16": [0, 0], "64x16": [0, 0]}
    for p in hyb.dense:
        R, W = p.src.shape
        t16 = (p.panel != 0).view(R, 8, 16, W * 8, 16).any(dim=4).any(dim=2)
        for key, t in (("16x16", t16),
                       ("64x16", t16.view(R, 2, 4, W * 8).any(dim=2))):
            tiles[key][0] += int(t.sum())
            tiles[key][1] += t.numel()
    for key, (nz, total) in tiles.items():
        print(f"{key} tiles that hold an edge: {nz} of {total} "
              f"({nz / total})")


if __name__ == "__main__":
    main()
