#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gardenia_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing its lines; any failure exits non-zero and prints no
result:
  1. environment: nvidia-smi's name and power limit, torch, CUDA, nvcc;
  2. build: compiles csrc/*.cu with nvcc (gardenia_tpu_torch/ops/_build.py);
  3. kernel K1 (dense_panel_matmul) against its plain PyTorch version on
     the card, every width bucket of an R-MAT-16 hybrid layout at S = 1
     and 8 (int8 panels), plus f32- and bf16-panel layouts of weighted
     random graphs; limit max|diff| / max|y| < 1e-5.  Then pull PageRank
     on R-MAT-16 on the card against the serial numpy oracle;
  4. the main path: the port's bench (python -m gardenia_tpu_torch.bench),
     pull PageRank on R-MAT-20 over the hybrid layout — generate, relabel,
     build_hybrid, upload, pr_solver on cuda — with K1's launch count read
     around it, the oracle's residual, and one spmv_hybrid apply timed
     with K1 and with the plain version.
The line before the last is a JSON object with the kernels' launches,
errors and times; the last line is {"ok": true, "device": {...}}.

Needs CUDA: without a card, or without the repository around it, it
exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SMOKE_SCALE = 16            # K1's width buckets and the oracle check
MAIN_SCALE = 20             # the bench's default graph: |V| = 2^20
K1_REL_LIMIT = 1e-5
K1_SOURCE = "gardenia_tpu_torch/csrc/dense_panel_matmul.cu"
K1_REPLACES = "gardenia_tpu/ops/pallas_bsr.py:67"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        fail(f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr}")
    return proc.stdout.strip()


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds of fn() over reps, by CUDA events."""
    import torch
    for _ in range(warmup):
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


def weighted_graph(kind: str, scale: int = 14, seed: int = 3):
    """Degree-relabelled symmetric R-MAT graph with numpy weights that
    make f32 (fractional) or bf16 (integers 128..255) panels."""
    from gardenia_tpu.core.generate import rmat_edges
    from gardenia_tpu.core.graph import from_edges
    from gardenia_tpu.core.relabel import degree_relabel
    e = rmat_edges(scale, degree=16, seed=seed)
    rng = np.random.default_rng(seed)
    e.wt = (rng.random(len(e.src)) + 0.5 if kind == "f32"
            else rng.integers(128, 256, len(e.src))).astype(np.float64)
    return degree_relabel(from_edges(e, symmetrize=True)).graph


def check_k1(hyb, label: str, S_list, dev, worst: dict) -> None:
    """K1 against its plain version on every panel array of hyb."""
    import torch
    from gardenia_tpu_torch.ops import panel
    qx = max(int(p.src.max()) for p in hyb.dense) + 1
    rng = np.random.default_rng(7)
    for S in S_list:
        x3d = torch.from_numpy(
            rng.random((qx, 128, S)).astype(np.float32)).to(dev)
        for p in hyb.dense:
            y_k = panel.dense_panel_matmul(p.panel, p.src, x3d, S)
            y_p = panel.dense_panel_matmul_plain(p.panel, p.src, x3d, S)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            rel = err / max(1e-30, float(y_p.abs().max()))
            worst["abs"] = max(worst["abs"], err)
            print(f"  K1 {label} {str(p.panel.dtype)[6:]} W={p.width:2d} "
                  f"R={p.src.shape[0]:6d} S={S}: max|diff| {err:.3e} "
                  f"rel {rel:.3e}")
            if not (np.isfinite(rel) and rel < K1_REL_LIMIT):
                fail(f"K1 disagrees with its plain version ({label}, "
                     f"W={p.width}, S={S}): rel {rel}")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA GPU")
    import gardenia_tpu_torch                         # the repository
    from gardenia_tpu.core.generate import generate_graph
    from gardenia_tpu.core.relabel import degree_relabel
    from gardenia_tpu.verify import oracles
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.core import views
    from gardenia_tpu_torch.ops import _build, bsr, panel
    from gardenia_tpu_torch.solvers.pr import EPSILON, pr_solver

    dev = gardenia_tpu_torch.resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain version in f32
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. environment ---------------------------------------------------
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc_release = [ln for ln in run([_build.find_nvcc(), "--version"])
                    .splitlines() if "release" in ln]
    print(gpu)                                   # nvidia-smi's own line
    print(f"[1] torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"device_count {torch.cuda.device_count()}")
    print(f"[1] nvcc: {nvcc_release[0].strip() if nvcc_release else '?'}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    so = _build.build(force=True)
    _build.lib()
    print(f"[2] built {so} from {len(_build.sources())} source(s) in "
          f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. K1 against its plain version, on the card ---------------------
    worst = {"abs": 0.0}
    g16 = generate_graph("rmat", scale=SMOKE_SCALE, degree=16,
                         symmetrize=True, need_reverse=True)
    g16r = degree_relabel(g16).graph
    hyb16 = bsr.build_hybrid(g16r.rowptr, g16r.colidx, None,
                             num_cols=g16r.n, dense_threshold=16).to(dev)
    widths = sorted({p.width for p in hyb16.dense})
    print(f"[3] rmat{SMOKE_SCALE}: {len(hyb16.dense)} panel arrays, "
          f"widths {widths}")
    if not hyb16.dense or any(p.panel.dtype != torch.int8
                              for p in hyb16.dense):
        fail("the R-MAT layout must hold int8 panels")
    check_k1(hyb16, f"rmat{SMOKE_SCALE}", (1, 8), dev, worst)
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gw = weighted_graph(kind)
        hw = bsr.build_hybrid(gw.rowptr, gw.colidx, gw.weights,
                              num_cols=gw.n, dense_threshold=16).to(dev)
        if not hw.dense or any(p.panel.dtype != dtype for p in hw.dense):
            fail(f"the weighted layout must hold {dtype} panels")
        check_k1(hw, f"weighted-{kind}", (1, 8), dev, worst)
    print(f"[3] K1 matches its plain version in every bucket: worst "
          f"max|diff| {worst['abs']:.3e}")
    # the hybrid SpMV on the card against the serial oracle
    x16 = np.random.default_rng(1).random(g16r.n).astype(np.float32)
    y16 = bsr.spmv_hybrid(hyb16, torch.from_numpy(x16).to(dev),
                          num_rows=g16r.m).cpu().numpy()
    y16_o = oracles.spmv_serial(g16r, np.ones(g16r.nnz, np.float32), x16)
    rel = float(np.abs(y16 - y16_o).max() / np.abs(y16_o).max())
    print(f"[3] spmv_hybrid rmat{SMOKE_SCALE} vs serial oracle: rel {rel:.3e}")
    if not rel < 1e-5:
        fail(f"spmv_hybrid disagrees with the serial oracle: {rel}")
    res16 = pr_solver(g16, device=dev)
    exp16, it16, _ = oracles.pagerank_serial(g16)
    l1 = float(np.abs(res16.scores.cpu().numpy() - exp16).sum())
    print(f"[3] pr rmat{SMOKE_SCALE} on {dev}: {res16.iterations} iterations "
          f"(serial oracle {it16}), L1 vs oracle {l1:.3e}")
    if not l1 < EPSILON:
        fail(f"PageRank on the card disagrees with the serial oracle: {l1}")

    # ---- 4. the main path: the bench's PR at R-MAT-20 ---------------------
    t0 = time.perf_counter()
    g = bench.get_graph(MAIN_SCALE)
    t_gen = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    views.relabeled_hybrid(g, dev)      # relabel, build_hybrid, upload
    torch.cuda.synchronize()
    print(f"[4] host set-up: generate {t_gen:.1f} s, relabel + build_hybrid"
          f" + upload {time.perf_counter() - t0:.1f} s")
    solves = bench.WARMUP + bench.ITERS
    panel.LAUNCHES = 0
    record, g, res = bench.bench_pr(MAIN_SCALE, dev, g=g)
    launches = panel.LAUNCHES
    print(json.dumps(record))
    _, hyb, _ = views.relabeled_hybrid(g, dev)
    n_panels = len(hyb.dense)
    iters = res.iterations
    print(f"[4] rmat{MAIN_SCALE}: |V| {g.m} |E| {g.nnz}, {n_panels} panel "
          f"arrays, {hyb.num_blocks} blocks, {iters} iterations, "
          f"K1 launches {launches} over {solves} solves, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not 0 < iters < 100:
        fail(f"PR did not converge: {iters} iterations")
    if launches == 0 or launches != solves * iters * n_panels:
        fail(f"K1 launches {launches} != {solves} x {iters} x {n_panels}")
    panel.LAUNCHES = 0
    res = pr_solver(g, device=dev)
    one = panel.LAUNCHES
    scores = res.scores.cpu().numpy()
    if scores.shape != (g.m,) or not np.isfinite(scores).all():
        fail("scores are not finite of shape (m,)")
    resid = oracles.pagerank_push_residual(g, scores)
    print(f"[4] one solve: {res.iterations} iterations, K1 launches {one}, "
          f"residual {resid:.3e}")
    if one != res.iterations * n_panels:
        fail(f"K1 launches {one} != {res.iterations} x {n_panels}")
    if not resid < EPSILON:
        fail(f"residual {resid} >= {EPSILON}")

    # one apply at the main path's shapes: K1 against the plain version,
    # in turns (plain, K1, K1, plain) on this card
    x = torch.from_numpy(np.random.default_rng(2).random(g.n)
                         .astype(np.float32)).to(dev)
    qx = (g.n + 127) // 128
    x3d = torch.zeros(qx * 128, device=dev)
    x3d[:g.n] = x
    x3d = x3d.view(qx, 128, 1)

    # K1 against its plain version at the main path's shapes
    main_abs = 0.0
    for p in hyb.dense:
        y_k = panel.dense_panel_matmul(p.panel, p.src, x3d, 1)
        y_p = panel.dense_panel_matmul_plain(p.panel, p.src, x3d, 1)
        torch.cuda.synchronize()
        err = float((y_k - y_p).abs().max())
        rel = err / max(1e-30, float(y_p.abs().max()))
        main_abs = max(main_abs, err)
        if not (np.isfinite(rel) and rel < K1_REL_LIMIT):
            fail(f"K1 disagrees with its plain version at rmat{MAIN_SCALE} "
                 f"W={p.width}: rel {rel}")
        del y_k, y_p
    print(f"[4] K1 vs plain on the rmat{MAIN_SCALE} panels, S=1: max|diff| "
          f"{main_abs:.3e} (limit {K1_REL_LIMIT} x max|y| per panel array)")

    def dense(fn):
        return lambda: [fn(p.panel, p.src, x3d, 1) for p in hyb.dense]

    def apply(fn):
        def go():
            keep, panel.dense_panel_matmul = panel.dense_panel_matmul, fn
            try:
                return bsr.spmv_hybrid(hyb, x, num_rows=g.m)
            finally:
                panel.dense_panel_matmul = keep
        return go

    k1, plain = panel.dense_panel_matmul, panel.dense_panel_matmul_plain
    t = {"dense_plain": [], "dense_k1": [], "apply_plain": [],
         "apply_k1": []}
    for which in ("plain", "k1", "k1", "plain"):
        fn = k1 if which == "k1" else plain
        t[f"dense_{which}"].append(cuda_ms(dense(fn)))
        t[f"apply_{which}"].append(cuda_ms(apply(fn)))
    ms = {k: sum(v) / len(v) for k, v in t.items()}
    panel_bytes = sum(p.panel.numel() * p.panel.element_size()
                      for p in hyb.dense)
    print(f"[4] gpu: {gpu}")
    print(f"[4] dense panels, one apply: K1 {ms['dense_k1']:.3f} ms, plain "
          f"{ms['dense_plain']:.3f} ms; panel stream {panel_bytes / 1e9:.3f}"
          f" GB -> K1 {panel_bytes / ms['dense_k1'] / 1e6:.0f} GB/s")
    print(f"[4] spmv_hybrid, one apply: with K1 {ms['apply_k1']:.3f} ms, "
          f"with plain {ms['apply_plain']:.3f} ms (runs "
          + json.dumps({k: [round(v, 4) for v in vs]
                        for k, vs in t.items()}) + ")")

    print(json.dumps({"kernels": [{
        "name": "dense_panel_matmul", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "max_abs_err": main_abs, "ms": ms["dense_k1"],
        "plain_ms": ms["dense_plain"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
