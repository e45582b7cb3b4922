#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gardenia_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of the repository

Phases, each printing its lines; any failure exits non-zero and prints no
result:
  1. environment: nvidia-smi's name and power limit, torch, CUDA, nvcc;
  2. build: compiles csrc/*.cu with nvcc, one process per source, in
     parallel (gardenia_tpu_torch/ops/_build.py);
  3. kernel K1 (dense_panel_matmul) against its plain PyTorch version on
     the card, every width bucket of an R-MAT-16 hybrid layout at S = 1
     and 8 (int8 panels), plus f32- and bf16-panel layouts of weighted
     random graphs; limit max|diff| / max|y| < 1e-5.  Then pull PageRank
     on R-MAT-16 on the card against the serial numpy oracle;
  4. the PR main path: the port's bench (python -m gardenia_tpu_torch.bench),
     pull PageRank on R-MAT-20 over the hybrid layout — generate, relabel,
     build_hybrid, upload, pr_solver on cuda — with K1's launch count read
     around it, the oracle's residual, and one spmv_hybrid apply timed
     with K1 and with the plain version;
  5. triangle counting's kernels K3 (rot_count), K4 (merge_count) and H1
     (bitmap_count) against their plain versions on the card, pair by
     pair with exact integer equality, in every width class of the
     R-MAT-16 streams, K3 and K4 each on every class (the routes that
     MERGE_MIN_W = 256 and 8 take); then tc_solver on R-MAT-16 (rotate
     under the three routings, and bsearch) against the serial oracle;
  6. the TC main path: the port's bench (--kernel tc) on phase 4's
     R-MAT-20 graph — orient, host prep, upload, tc_solver on cuda — with
     the launch counts of K3, K4 and H1 read around it (classes x
     solves), the count held to the JAX package's 424,573,866 and to the
     plain route's and tc_bsearch's counts, then per class the kernel
     against its plain version (pairs, ms in turns plain/kernel/kernel/
     plain, GB/s of rows read, per-pair equality) and peak device memory;
  7. connected components' kernel K2 (dense_panel_minselect) against its
     plain version on the card, exact, in every panel array of the
     R-MAT-16 layout, of the f32 and bf16 weighted layouts and of the
     R-MAT-20 layout; then cc_sv (hybrid and ell layouts) and cc_afforest
     on uniform-14, whose cc_sv takes a dense round and so launches K2
     inside the solve (its launch count must be > 0), each held to the
     serial oracle by the CLI's bijection check;
  8. the CC main path: the port's bench (--kernel cc), cc_sv on phase 4's
     R-MAT-20 graph, with K2's launch count read around it (0 when no
     round is dense), its components held to the serial oracle and
     cc_afforest's and the ell layout's agreeing; then the dense sweep
     itself, spmv_hybrid_min_select on the R-MAT-20 layout with identity
     labels, against the plain route and an ELL-only min-select of the
     same matrix, exact, and timed (K2 alone, plain alone, whole sweeps)
     with CUDA events in turns plain/kernel/kernel/plain.
The line before the last is a JSON object with every kernel's launches,
error, times and bound (bound_ms: the larger of the bytes each input and
output moves once over 3.35 TB/s and the operations over the card's
non-tensor peak, from this run's inputs); the last line is
{"ok": true, "device": {...}}.

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
CC_UNIFORM_SCALE = 14       # cc_sv takes a dense round there (K2 runs)
K1_REL_LIMIT = 1e-5
K1_SOURCE = "gardenia_tpu_torch/csrc/dense_panel_matmul.cu"
K1_REPLACES = "gardenia_tpu/ops/pallas_bsr.py:67"
K2_SOURCE = "gardenia_tpu_torch/csrc/dense_panel_minselect.cu"
K2_REPLACES = "gardenia_tpu/ops/pallas_bsr.py:113"
SENT = 2 ** 31 - 1          # the min-select sentinel (INT32_MAX)
# published peaks of one H100 SXM (NVIDIA's H100 datasheet): device
# memory bytes/s, and the non-tensor f32 rate, taken for the CUDA-core
# integer and f32 work of every kernel here (none uses tensor cores)
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
# triangle counting: wrapper name in ops/tc_count -> (kernel, source, the
# TPU code it replaces; H1 replaces an XLA pass, there was no Pallas kernel)
TC_KERNELS = {
    "rot_count": ("K3", "gardenia_tpu_torch/csrc/tc_rot_count.cu",
                  "gardenia_tpu/solvers/tc.py:197"),
    "merge_count": ("K4", "gardenia_tpu_torch/csrc/tc_merge_count.cu",
                    "gardenia_tpu/solvers/tc.py:303"),
    "bitmap_count": ("H1", "gardenia_tpu_torch/csrc/tc_bitmap_count.cu",
                     "gardenia_tpu/solvers/tc.py:351"),
}
# the JAX package's count on the bench's R-MAT-20 graph, in three rounds
# (BENCH_SWEEP_r2.jsonl:7, BENCH_SWEEP_r3.jsonl:6, BENCH_SWEEP_r5.jsonl:6)
TC_RMAT20_TRIANGLES = 424_573_866


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
    from gardenia_tpu_torch.core.generate import rmat_edges
    from gardenia_tpu_torch.core.graph import from_edges
    from gardenia_tpu_torch.core.relabel import degree_relabel
    e = rmat_edges(scale, degree=16, seed=seed)
    rng = np.random.default_rng(seed)
    e.wt = (rng.random(len(e.src)) + 0.5 if kind == "f32"
            else rng.integers(128, 256, len(e.src))).astype(np.float64)
    return degree_relabel(from_edges(e, symmetrize=True)).graph


def check_k1(hyb, label: str, S_list, dev, k1: dict) -> float:
    """K1 against its plain version on every panel array of hyb: counts
    the arrays checked and those at or over K1_REL_LIMIT into k1, and
    returns the worst max|diff|."""
    import torch
    from gardenia_tpu_torch.ops import panel
    qx = max(int(p.src.max()) for p in hyb.dense) + 1
    rng = np.random.default_rng(7)
    worst = 0.0
    for S in S_list:
        x3d = torch.from_numpy(
            rng.random((qx, 128, S)).astype(np.float32)).to(dev)
        for p in hyb.dense:
            y_k = panel.dense_panel_matmul(p.panel, p.src, x3d, S)
            y_p = panel.dense_panel_matmul_plain(p.panel, p.src, x3d, S)
            torch.cuda.synchronize()
            err = float((y_k - y_p).abs().max())
            rel = err / max(1e-30, float(y_p.abs().max()))
            worst = max(worst, err)
            bad = not (np.isfinite(rel) and rel < K1_REL_LIMIT)
            k1["arrays_checked"] += 1
            k1["mismatches"] += int(bad)
            print(f"  K1 {label} {str(p.panel.dtype)[6:]} W={p.width:2d} "
                  f"R={p.src.shape[0]:6d} S={S}: max|diff| {err:.3e} "
                  f"rel {rel:.3e}")
            if bad:
                fail(f"K1 disagrees with its plain version ({label}, "
                     f"W={p.width}, S={S}): rel {rel}")
    return worst


def bound(nbytes: float, ops: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the vector peak."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / VECTOR_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def panel_work(hyb, x_bytes: int) -> tuple:
    """(bytes, cells, nonzero cells) of one sweep over hyb's panel arrays:
    each panel, block table and 4-byte output once, plus the operand
    once."""
    nbytes, cells, nnz = x_bytes, 0, 0
    for p in hyb.dense:
        nbytes += (p.panel.numel() * p.panel.element_size()
                   + p.src.numel() * 4
                   + p.src.shape[0] * 128 * 4)
        cells += p.panel.numel()
        nnz += int((p.panel != 0).sum())
    return nbytes, cells, nnz


def check_k2(hyb, label: str, dev, k2: dict) -> None:
    """K2 against its plain version on every panel array of hyb, with
    random labels (the sentinel in the last pad slots): exact."""
    import torch
    from gardenia_tpu_torch.ops import minselect
    qx = max(int(p.src.max()) for p in hyb.dense) + 1
    x2d = np.full(qx * 128, SENT, np.int32)
    x2d[:-5] = np.random.default_rng(17).integers(0, 1 << 30,
                                                  qx * 128 - 5)
    x2d = torch.from_numpy(x2d.reshape(qx, 128)).to(dev)
    for p in hyb.dense:
        y_k = minselect.dense_panel_minselect(p.panel, p.src, x2d, SENT)
        y_p = minselect.dense_panel_minselect_plain(p.panel, p.src, x2d,
                                                    SENT)
        torch.cuda.synchronize()
        if y_k.shape != y_p.shape or y_k.dtype != torch.int32:
            fail(f"K2 {label}: shape/dtype {y_k.shape} {y_k.dtype} vs "
                 f"plain {y_p.shape} {y_p.dtype}")
        diff = (y_k.long() - y_p.long()).abs()
        bad = int((diff != 0).sum())
        k2["arrays_checked"] += 1
        k2["rows_checked"] += int(y_k.numel())
        k2["mismatches"] += bad
        k2["max_abs_err"] = max(k2["max_abs_err"], int(diff.max()))
        print(f"  K2 {label} {str(p.panel.dtype)[6:]} W={p.width:2d} "
              f"R={p.src.shape[0]:6d}: {bad} of {y_k.numel()} rows differ")
        if bad:
            fail(f"K2 disagrees with its plain version ({label}, "
                 f"W={p.width}): {bad} rows")


def tc_pairs(data):
    """(name, kernel fn, plain fn, pairs, bytes of rows read, class label)
    for every pair stream of a TCData: H1 on the hub pairs, then K3 and
    K4 each on every width class."""
    from gardenia_tpu_torch.ops import tc_count as tcc
    out = []
    if data.bitmap is not None:
        bmp, hu, hv = data.bitmap
        out.append(("bitmap_count", lambda: tcc.bitmap_count(bmp, hu, hv),
                    lambda: tcc.bitmap_count_plain(bmp, hu, hv), len(hu),
                    8 * bmp.shape[1] * len(hu), "hub"))
    for W, (cu, cv) in sorted(data.streams.items()):
        t = data.table
        out.append(("rot_count",
                    lambda t=t, cu=cu, cv=cv, W=W: tcc.rot_count(t, cu, cv, W),
                    lambda t=t, cu=cu, cv=cv, W=W:
                    tcc.rot_count_plain(t, cu, cv, W),
                    len(cu), (512 + 4 * W) * len(cu), f"W{W}"))
        out.append(("merge_count",
                    lambda t=t, cu=cu, cv=cv: tcc.merge_count(t, cu, cv),
                    lambda t=t, cu=cu, cv=cv: tcc.merge_count_plain(t, cu, cv),
                    len(cu), 1024 * len(cu), f"W{W}"))
    return out


def tc_compare(name, y_k, y_p, label, stats) -> None:
    """Exact per-pair equality of a TC kernel with its plain version."""
    import torch
    torch.cuda.synchronize()
    if y_k.shape != y_p.shape or y_k.dtype != torch.int32:
        fail(f"{TC_KERNELS[name][0]} {label}: shape/dtype {y_k.shape} "
             f"{y_k.dtype} vs plain {y_p.shape} {y_p.dtype}")
    diff = (y_k.long() - y_p.long()).abs()
    bad = int((diff != 0).sum())
    err = int(diff.max()) if diff.numel() else 0
    st = stats[name]
    st["mismatches"] += bad
    st["max_abs_err"] = max(st["max_abs_err"], err)
    st["pairs_checked"] += int(y_k.numel())
    if bad:
        fail(f"{TC_KERNELS[name][0]} {label}: {bad} of {y_k.numel()} pairs "
             f"differ from the plain version (max |diff| {err})")


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA GPU")
    import gardenia_tpu_torch                         # the repository
    from gardenia_tpu_torch.core.generate import generate_graph
    from gardenia_tpu_torch.core.relabel import degree_relabel
    from gardenia_tpu_torch.verify import oracles
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
    # panel arrays checked, and those at or over K1_REL_LIMIT
    k1_stats = {"arrays_checked": 0, "mismatches": 0}
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
    worst = check_k1(hyb16, f"rmat{SMOKE_SCALE}", (1, 8), dev, k1_stats)
    weighted = {}                       # phase 7 checks K2 on them too
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gw = weighted_graph(kind)
        hw = bsr.build_hybrid(gw.rowptr, gw.colidx, gw.weights,
                              num_cols=gw.n, dense_threshold=16).to(dev)
        weighted[kind] = hw
        if not hw.dense or any(p.panel.dtype != dtype for p in hw.dense):
            fail(f"the weighted layout must hold {dtype} panels")
        worst = max(worst, check_k1(hw, f"weighted-{kind}", (1, 8), dev,
                                    k1_stats))
    print(f"[3] K1 matches its plain version in every bucket: worst "
          f"max|diff| {worst:.3e}")
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
    main_abs = check_k1(hyb, f"rmat{MAIN_SCALE}", (1,), dev, k1_stats)
    print(f"[4] K1 vs plain on the rmat{MAIN_SCALE} panels, S=1: max|diff| "
          f"{main_abs:.3e} (limit {K1_REL_LIMIT} x max|y| per panel array); "
          f"{k1_stats['mismatches']} of {k1_stats['arrays_checked']} panel "
          f"arrays checked in all over the limit")

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

    # ---- 5. TC kernels against their plain versions; R-MAT-16 TC --------
    from gardenia_tpu_torch.ops import tc_count as tcc
    from gardenia_tpu_torch.solvers import tc
    stats = {name: {"mismatches": 0, "max_abs_err": 0, "pairs_checked": 0}
             for name in TC_KERNELS}
    data16 = tc.tc_data(tc.tc_dag(g16), True, dev)
    if data16.bitmap is None or len(data16.streams) != len(tc.ROT_WIDTHS):
        fail(f"rmat{SMOKE_SCALE} must give hub pairs and every width class")
    for name, k_fn, p_fn, n, _, label in tc_pairs(data16):
        tc_compare(name, k_fn(), p_fn(), label, stats)
        print(f"[5] {TC_KERNELS[name][0]} rmat{SMOKE_SCALE} {label:>4}: "
              f"{n:7d} pairs, equal to the plain version")
    want16 = oracles.tc_serial(g16.oriented())
    keep_mmw = tc.MERGE_MIN_W
    try:
        for mmw in (keep_mmw, 256, 8):
            tc.MERGE_MIN_W = mmw
            got = tc.tc_solver(g16, device=dev)
            print(f"[5] tc rotate rmat{SMOKE_SCALE}, MERGE_MIN_W={mmw}: "
                  f"{got} (serial oracle {want16})")
            if got != want16:
                fail(f"TC rotate (MERGE_MIN_W={mmw}) counts {got}, the "
                     f"serial oracle {want16}")
    finally:
        tc.MERGE_MIN_W = keep_mmw
    got = tc.tc_solver(g16, variant="bsearch", device=dev)
    print(f"[5] tc bsearch rmat{SMOKE_SCALE}: {got}")
    if got != want16:
        fail(f"TC bsearch counts {got}, the serial oracle {want16}")

    # ---- 6. the TC main path: the bench's TC at R-MAT-20 ------------------
    t0 = time.perf_counter()
    dag = tc.tc_dag(g)                  # relabel cached by phase 4, orient
    t_orient = time.perf_counter() - t0
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    data = tc.tc_data(dag, True, dev)   # chunk table, bitmap, streams
    torch.cuda.synchronize()
    t_prep = time.perf_counter() - t0
    print(f"[6] host set-up: orient {t_orient:.1f} s, prep + upload "
          f"{t_prep:.1f} s; DAG edges {dag.nnz}, chunk rows "
          f"{data.table.shape[0] - 1}, hub bitmap "
          f"{tuple(data.bitmap[0].shape) if data.bitmap else None}")
    solves = bench.TC_WARMUP + bench.TC_ITERS
    tcc.reset_launches()
    record, g, total = bench.bench_tc(MAIN_SCALE, dev, g=g)
    tc_launches = dict(tcc.LAUNCHES)
    print(json.dumps(record))
    peak_tc = torch.cuda.max_memory_allocated() - resident
    n_rot = sum(1 for W in data.streams if W < tc.MERGE_MIN_W)
    want_launches = {"rot_count": n_rot * solves,
                     "merge_count": (len(data.streams) - n_rot) * solves,
                     "bitmap_count": (data.bitmap is not None) * solves}
    print(f"[6] rmat{MAIN_SCALE}: {total} triangles, launches {tc_launches}"
          f" over {solves} solves, peak device memory of TC "
          f"{peak_tc / 2**30:.3f} GiB above the {resident / 2**30:.2f} GiB "
          f"resident before it")
    if tc_launches != want_launches or 0 in tc_launches.values():
        fail(f"TC launches {tc_launches} != classes x solves "
             f"{want_launches}")
    if total != TC_RMAT20_TRIANGLES:
        fail(f"TC counts {total} triangles at rmat{MAIN_SCALE}, the JAX "
             f"package {TC_RMAT20_TRIANGLES}")
    # the plain route: the solver with every wrapper swapped for its plain
    # version; no kernel may launch
    kernels = (tcc.rot_count, tcc.merge_count, tcc.bitmap_count)
    tcc.rot_count, tcc.merge_count, tcc.bitmap_count = (
        tcc.rot_count_plain, tcc.merge_count_plain, tcc.bitmap_count_plain)
    try:
        t0 = time.perf_counter()
        plain_total = tc.tc_solver(g, device=dev, chunk=1 << 16)
        t_plain = time.perf_counter() - t0
    finally:
        tcc.rot_count, tcc.merge_count, tcc.bitmap_count = kernels
    t0 = time.perf_counter()
    bs_total = tc.tc_solver(g, variant="bsearch", device=dev, chunk=1 << 22)
    t_bs = time.perf_counter() - t0
    print(f"[6] plain route {plain_total} ({t_plain:.2f} s), tc_bsearch "
          f"{bs_total} ({t_bs:.2f} s), launches after {dict(tcc.LAUNCHES)}")
    if tcc.LAUNCHES != tc_launches:
        fail("a TC kernel launched on the plain route")
    if not plain_total == bs_total == total:
        fail(f"TC routes disagree: kernels {total}, plain {plain_total}, "
             f"bsearch {bs_total}")

    # per class at the main path's shapes: the routed kernel against its
    # plain version, in turns (plain, kernel, kernel, plain) on this card
    # bound per routed class: the table (or bitmap) and the pair streams
    # each moved once; operations as the kernels do them — K3 W*128
    # compares a pair, K4 128 binary searches of 7 steps, H1 an AND and a
    # popcount per 32-bit word of a row
    tc_ms = {name: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
             for name in TC_KERNELS}
    breakdown = []
    for name, k_fn, p_fn, n, nbytes, label in tc_pairs(data):
        W = int(label[1:]) if label != "hub" else None
        if W is not None and (name == "merge_count") != (
                W >= tc.MERGE_MIN_W):
            continue                        # not the route the solver takes
        if W is None:
            words = data.bitmap[0].shape[1]
            tc_ms[name]["bytes"] += data.bitmap[0].numel() * 4 + 12 * n
            tc_ms[name]["ops"] += 2 * words * n
        else:
            tc_ms[name]["bytes"] += data.table.numel() * 4 + 12 * n
            tc_ms[name]["ops"] += (W * 128 if name == "rot_count"
                                   else 128 * 7) * n
        tc_compare(name, k_fn(), p_fn(), f"rmat{MAIN_SCALE} {label}", stats)
        t = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            t[which].append(cuda_ms(k_fn if which == "kernel" else p_fn,
                                    reps=10 if which == "kernel" else 2,
                                    warmup=1))
        k_ms, p_ms = (sum(t[w]) / 2 for w in ("kernel", "plain"))
        tc_ms[name]["ms"] += k_ms
        tc_ms[name]["plain_ms"] += p_ms
        breakdown.append({"class": label, "kernel": TC_KERNELS[name][0],
                          "pairs": n, "ms": k_ms, "plain_ms": p_ms,
                          "gb_per_s": nbytes / k_ms / 1e6,
                          "runs": {w: [round(v, 4) for v in vs]
                                   for w, vs in t.items()}})
        print(f"[6] {TC_KERNELS[name][0]} {label:>4}: {n:8d} pairs, kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, rows read "
              f"{nbytes / 1e9:.3f} GB -> {nbytes / k_ms / 1e6:.0f} GB/s")
    print(f"[6] gpu: {gpu}")
    print("[6] tc breakdown " + json.dumps(breakdown))
    print("[6] TC kernels vs plain: " + json.dumps(stats))

    # ---- 7. K2 against its plain version; CC on uniform-14 ---------------
    from gardenia_tpu_torch.cli import same_components
    from gardenia_tpu_torch.ops import minselect
    from gardenia_tpu_torch.ops.semiring import I32_MIN_SELECT2
    from gardenia_tpu_torch.ops.spmv import spmv_ell
    from gardenia_tpu_torch.solvers import cc
    k2_stats = {"arrays_checked": 0, "rows_checked": 0, "mismatches": 0,
                "max_abs_err": 0}
    check_k2(hyb16, f"rmat{SMOKE_SCALE}", dev, k2_stats)
    for kind, hw in weighted.items():
        check_k2(hw, f"weighted-{kind}", dev, k2_stats)
    check_k2(hyb, f"rmat{MAIN_SCALE}", dev, k2_stats)
    print(f"[7] K2 vs plain, exact: {json.dumps(k2_stats)}")

    def cc_check(phase, label, res, m, want) -> None:
        comp = res.comp.cpu().numpy()
        ok = comp.shape == (m,) and same_components(comp, want)
        print(f"[{phase}] {label}: {res.iterations} rounds, "
              f"{len(np.unique(comp))} "
              f"components (serial oracle {len(np.unique(want))}): "
              f"{'Correct' if ok else 'Wrong'}")
        if not ok:
            fail(f"CC {label} disagrees with the serial oracle")

    gu = generate_graph("uniform", scale=CC_UNIFORM_SCALE)
    want_u = oracles.cc_serial(gu)
    minselect.LAUNCHES = 0
    res_u = cc.cc_sv(gu, layout="hybrid", device=dev)
    k2_uniform = minselect.LAUNCHES
    gu_panels = len(views.hybrid(views.relabel_maps(gu, dev)[0], dev).dense)
    lbl = f"uniform{CC_UNIFORM_SCALE}"
    cc_check(7, f"cc_sv hybrid {lbl}", res_u, gu.m, want_u)
    cc_check(7, f"cc_sv ell {lbl}", cc.cc_sv(gu, layout="ell", device=dev),
             gu.m, want_u)
    cc_check(7, f"cc_afforest {lbl}", cc.cc_afforest(gu, device=dev), gu.m,
             want_u)
    print(f"[7] {lbl}: |V| {gu.m} |E| {gu.nnz}; K2 launches in the cc_sv "
          f"hybrid solve {k2_uniform} ({gu_panels} panel arrays x dense "
          f"rounds)")
    if k2_uniform == 0 or k2_uniform % gu_panels:
        fail(f"K2 launched {k2_uniform} times in the {lbl} cc_sv solve")

    # ---- 8. the CC main path: the bench's CC at R-MAT-20 ------------------
    solves = bench.WARMUP + bench.ITERS
    minselect.LAUNCHES = 0
    record, g, res_cc = bench.bench_cc(MAIN_SCALE, dev, g=g)
    k2_bench = minselect.LAUNCHES
    print(json.dumps(record))
    print(f"[8] rmat{MAIN_SCALE}: {res_cc.iterations} rounds, K2 launches "
          f"{k2_bench} over {solves} solves (0 unless a round is dense)")
    t0 = time.perf_counter()
    want = oracles.cc_serial(g)
    print(f"[8] serial oracle {time.perf_counter() - t0:.1f} s")
    cc_check(8, f"cc_sv hybrid rmat{MAIN_SCALE}", res_cc, g.m, want)
    cc_check(8, f"cc_sv ell rmat{MAIN_SCALE}",
             cc.cc_sv(g, layout="ell", device=dev), g.m, want)
    cc_check(8, f"cc_afforest rmat{MAIN_SCALE}",
             cc.cc_afforest(g, device=dev), g.m, want)

    # the dense sweep at the main path's shapes, identity labels: K2's
    # route against the plain route and an ELL-only min-select of the
    # same matrix, then timed in turns (plain, K2, K2, plain)
    g2 = views.relabel_maps(g, dev)[0]
    if views.hybrid(g2, dev) is not hyb:
        fail("CC's forward hybrid is not the PR layout's cache entry")
    ell2 = views.ell(g2, dev)
    ident = torch.arange(g.m, dtype=torch.int32, device=dev)
    qx = (g.n + 127) // 128
    x2d = torch.full((qx * 128,), SENT, dtype=torch.int32, device=dev)
    x2d[:g.n] = ident
    x2d = x2d.view(qx, 128)
    k2, k2_plain = (minselect.dense_panel_minselect,
                    minselect.dense_panel_minselect_plain)

    def k2_dense(fn):
        return lambda: [fn(p.panel, p.src, x2d, SENT) for p in hyb.dense]

    def k2_sweep(fn):
        def go():
            keep, minselect.dense_panel_minselect = \
                minselect.dense_panel_minselect, fn
            try:
                return bsr.spmv_hybrid_min_select(hyb, ident, num_rows=g.m,
                                                  sentinel=SENT)
            finally:
                minselect.dense_panel_minselect = keep
        return go

    def ell_sweep():
        return spmv_ell(ell2, ident, semiring=I32_MIN_SELECT2, num_rows=g.m)

    y_k, y_p, y_e = k2_sweep(k2)(), k2_sweep(k2_plain)(), ell_sweep()
    bad_p = int((y_k != y_p).sum())
    bad_e = int((y_k != y_e).sum())
    print(f"[8] min-select sweep rmat{MAIN_SCALE}: K2 route vs plain route "
          f"{bad_p} rows differ, vs ELL-only {bad_e} rows differ")
    if bad_p or bad_e:
        fail("the min-select sweep's routes disagree")
    t = {"dense_plain": [], "dense_k2": [], "sweep_plain": [],
         "sweep_k2": [], "sweep_ell": []}
    for which in ("plain", "k2", "k2", "plain"):
        fn = k2 if which == "k2" else k2_plain
        reps = 10 if which == "k2" else 2
        t[f"dense_{which}"].append(cuda_ms(k2_dense(fn), reps=reps,
                                           warmup=1))
        t[f"sweep_{which}"].append(cuda_ms(k2_sweep(fn), reps=reps,
                                           warmup=1))
        if which == "k2":
            t["sweep_ell"].append(cuda_ms(ell_sweep, reps=reps, warmup=1))
    cc_ms = {k: sum(v) / len(v) for k, v in t.items()}
    k2_bytes, cells, nz = panel_work(hyb, qx * 128 * 4)
    k2_bound = bound(k2_bytes, cells + nz)
    print(f"[8] gpu: {gpu}")
    print(f"[8] dense panels, one sweep: K2 {cc_ms['dense_k2']:.3f} ms, plain"
          f" {cc_ms['dense_plain']:.3f} ms; {k2_bytes / 1e9:.3f} GB moved "
          f"once -> K2 {k2_bytes / cc_ms['dense_k2'] / 1e6:.0f} GB/s, bound "
          f"{k2_bound[0]:.3f} ms ({k2_bound[1]}); {nz} nonzero of {cells} "
          f"cells")
    print(f"[8] min-select sweep, one apply: with K2 {cc_ms['sweep_k2']:.3f}"
          f" ms, with plain {cc_ms['sweep_plain']:.3f} ms, ELL only "
          f"{cc_ms['sweep_ell']:.3f} ms (runs "
          + json.dumps({k: [round(v, 4) for v in vs]
                        for k, vs in t.items()}) + ")")

    entries = [{
        "name": "dense_panel_matmul", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches,
        "mismatches": k1_stats["mismatches"],
        "max_abs_err": main_abs, "ms": ms["dense_k1"],
        "plain_ms": ms["dense_plain"],
        # the same bytes as K2's sweep (S = 1: one f32 out per row), a
        # multiply and an add per cell
        **dict(zip(("bound_ms", "bound_by"), bound(k2_bytes, 2 * cells))),
        "library_ms": None}, {
        "name": "dense_panel_minselect", "route": "cuda",
        "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": k2_bench + k2_uniform,
        "launches_by_path": {f"cc bench rmat{MAIN_SCALE}": k2_bench,
                             f"cc_sv uniform{CC_UNIFORM_SCALE}": k2_uniform},
        "mismatches": k2_stats["mismatches"],
        "max_abs_err": k2_stats["max_abs_err"], "ms": cc_ms["dense_k2"],
        "plain_ms": cc_ms["dense_plain"],
        "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
        "library_ms": None}]
    for name, (_, source, replaces) in TC_KERNELS.items():
        b_ms, b_by = bound(tc_ms[name]["bytes"], tc_ms[name]["ops"])
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": tc_launches[name],
            "mismatches": stats[name]["mismatches"],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": tc_ms[name]["ms"], "plain_ms": tc_ms[name]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
