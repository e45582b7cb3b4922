"""Headline benchmark of the port — prints ONE JSON line in the shape of
the repo's bench.py:
  {"metric": "pr_pull_gteps_rmat{scale}", "value": N, "unit": "GTEPS",
   "vs_baseline": N, "detail": {"iters", "ms", "nnz", "m", ...}}

Kernels, each on a Graph500 R-MAT graph, symmetrized (scale 20: |V| =
1,048,576), with the formula, repeats and baseline constant of the
repo's bench.py:
  pr — pull PageRank GTEPS: edges x iterations / solve time, best of 3
       after one warm-up solve that also builds and uploads the layout;
       vs 2.0 GTEPS.
  tc — `tc_meps_rmat{scale}`: edges / solve time / 1e6, best of 2 after
       one warm-up solve that also relabels, preps and uploads; vs 2000
       M edges/s; detail.triangles is the count.
  cc — `cc_sv_ms_rmat{scale}`: ms of cc_sv on the hybrid layout, best of
       3 after one warm-up solve that also relabels and uploads (the
       layout's panels are built only if a round is dense);
       vs_baseline = 1.0 ms per M edges / the measured ms per M edges;
       detail.rounds, and detail.k2_launches — K2's launches over the 4
       solves (0 when no round is dense).
  bfs — `bfs_dofused_gteps_rmat{scale}`: edges / solve time of the fused
       direction-optimizing BFS from the vertex of highest degree, best of
       3 after one warm-up; vs 30 GTEPS; detail.levels, detail.relax_gteps
       (edges x levels / time), detail.k1_launches over the 4 solves.
  msbfs — `msbfs128_gteps_rmat{scale}`: edges x sources / solve time of
       bfs_multi_source from sources 0..127, best of 3 after one warm-up;
       vs 30 GTEPS; detail.levels, detail.k1_launches and
       detail.k1_tc_launches (the tensor-core route's share).
  bc — `bc_batched128_gteps_rmat{scale}`: 2 x edges x sources / solve time
       of bc_batched from sources 0..127 (Brandes walks every edge forward
       and backward), best of 2 after one warm-up; vs 5 GTEPS; the same
       details.
  spmv — `spmv_gflops_rmat{scale}`: 2 x edges / the time of one apply, over
       a power loop of 8 hybrid applies (each normalized by max|y|), best
       of 3 after one warm-up; the layout is the PR layout (relabelled,
       threshold 16, int8 counts) with scale 0.2, the uniform values of
       the reference's src/spmv/main.cc; vs 55 GFLOP/s;
       detail.ms_per_apply, reps, and K1's launches over the 4 solves.
  sssp — `sssp_nf_gteps_grid{side}`: edges / solve time of near-far
       delta-stepping (delta 1024) from vertex 0 on the symmetrized
       weighted side x side grid, side = 2^(scale // 2), best of 2 after
       one warm-up; vs 1 GTEPS; detail.rounds.
  mst — `mst_boruvka_ms_rmat{scale}`: ms of Boruvka on the R-MAT graph
       with the integer weights (lo * 2654435761 + hi * 40503) % 97 + 1 of
       each unordered pair, best of 2 after one warm-up; vs_baseline = 2.0
       ms per M edges / the measured ms per M edges; detail.weight.
  scc — `scc_ms_rmat{scale}d`: ms of the 'color' SCC on the DIRECTED R-MAT
       graph (a symmetrized one degenerates to CC), best of 2 after one
       warm-up; vs_baseline = 1.0 ms per M edges / the measured; detail.
       sccs and rounds.
  vc — `vc_ms_rmat{scale}`: ms of vc_solver, best of 3 after one warm-up
       (which also finds the palette, remembered on the graph);
       vs_baseline = 1.0 ms per M edges / the measured; detail.num_colors,
       rounds (all, and by tier: dense, sparse, core), palette, core_size
       and v1_launches, kernel V1's launches over the 4 solves.
  symgs — `symgs_gflops_rmat{scale}`: 4 x edges / the best-of-3 seconds of
       one symmetric sweep (forward and backward over the colour blocks)
       after one warm-up; Ax, x, b from default_rng(13), diag = degree +
       1, the port's colouring as untimed set-up; vs 30 GFLOP/s;
       detail.colors and ms.
  sgd — `sgd_mf_mrps_rmat{scale}`: edges x 10 epochs / best-of-2 seconds
       / 1e6 of mini-batched SGD (step 0.1, epsilon 0) on the R-MAT graph
       with ratings integers(1, 6) from default_rng(13), the latent
       tables made and uploaded before the timed solves; vs 500 M
       ratings/s; detail.final_rmse and epochs.
  kcl — `kcl4_mcps_rmat{scale}`: 4-cliques / solve seconds / 1e6 of
       kcl_solver (kernel Q1 on route "q1"), one timed solve after one
       warm-up at scale >= 18 (best of 2 below); vs 200 M cliques/s;
       detail.route (what ran: q1, expand, or q1_plain where a DAG on the
       CPU took Q1's plain version), q1_launches (over all solves) and
       correct: the count equals the JAX package's record (291,554,165
       at scale 16, 17,113,600,315 at 20) on route q1, or else
       kcl_verifier's when |V| <= 5000, or else the plain route's on the
       same device (detail.check names which).
  motif — `motif4_meps_rmat{scale}`: edges / solve seconds / 1e6 of the
       4-motif census, repeats as kcl; vs 50 M edges/s; detail.census,
       aggregates ("streams" or "host_oracles"), kcl_route and
       q1_launches (the census's 4-cliques), n_parts and n_qparts (the
       wedge streams' partitions) and correct: the census equals the TPU
       record at scale 16; at 20 the 4-cliques equal kcl's record, the
       triangles over the edges 3 x 424,573,866 and the aggregates are
       the streams'; at both the 4-cliques took route q1; elsewhere the
       4-cliques equal kcl_solver's and the triangles over the edges 3 x
       tc_solver's.
  sgl — `sgl_diamond_meps_rmat{scale}`: edges / solve seconds / 1e6 of
       sgl_solver's diamond formula (wedge-stream triangles and kcl's
       4-cliques), repeats as kcl; vs 100 M edges/s; detail.count, route
       ("streams" or "wedge_sweep"), kcl_route and q1_launches (over all
       solves), and correct: the count equals the TPU record at scale 16
       (3,512,882,086); at 20 the 4-cliques equal kcl's record, the
       triangles over the edges 3 x 424,573,866, the route is streams and
       kcl's q1; elsewhere the count equals sgl_verifier's when |V| <= 40,
       else the pattern engine's (use_formula=False) on the same device.
  fsm — `fsm2_minsup5000_meps_rmat{scale}`: edges / solve seconds / 1e6 of
       fsm_solver at k = 2, minsup 5000, on the degree-bucket labels (the
       label aggregate over the forward hybrid layout), one timed solve
       after one warm-up; vs 5 M edges/s; detail.frequent_patterns,
       labels (L), lane_chunks, k1_launches by route over both solves and
       split_launches (0: the operands are bf16), and correct: the count
       equals the TPU record (2 at scale 16, 73 at 20), else fsm_gspan's
       on the same device.
The graph is generated anew from the generator's fixed seed in every
run; nothing is cached on disk.  `detail.device` names the card the
number was taken on.  Numbers are printed unrounded: a slow CPU rate
must not round to 0.

Run: python -m gardenia_tpu_torch.bench
         [--kernel {pr,tc,cc,bfs,msbfs,bc,spmv,sssp,mst,scc,vc,symgs,sgd,
                    kcl,motif,sgl,fsm}]
                                        [--scale 20] [--device cuda]
                                        [--quick]   (scale 16)
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.ops import panel

BASELINE_GTEPS = 2.0      # the constants of the repo's bench.py
BASELINE_TC_MEPS = 2000.0
BASELINE_CC_MS_PER_MEDGE = 1.0
BASELINE_BFS_GTEPS = 30.0
BASELINE_BC_GTEPS = 5.0
BASELINE_SPMV_GFLOPS = 55.0
BASELINE_SSSP_GTEPS = 1.0
BASELINE_MST_MS_PER_MEDGE = 2.0
BASELINE_SCC_MS_PER_MEDGE = 1.0
BASELINE_VC_MS_PER_MEDGE = 1.0
BASELINE_SYMGS_GFLOPS = 30.0
BASELINE_SGD_MRPS = 500.0
BASELINE_KCL4_MCPS = 200.0    # M 4-cliques listed / s
BASELINE_MOTIF4_MEPS = 50.0   # M edges / s for the 4-motif census
BASELINE_SGL_MEPS = 100.0     # M edges / s for SGL diamond
BASELINE_FSM_MEPS = 5.0       # M edges / s for FSM k = 2
# the JAX package's answers on the bench's graphs (BENCH_SWEEP_r5.jsonl:
# 11-14, 16, 17, 21; the triangles: BENCH_SWEEP_r2.jsonl:7), which a solve
# at these scales must give exactly
KCL4_RECORD = {16: 291_554_165, 20: 17_113_600_315}
TC_RECORD = {20: 424_573_866}
MOTIF4_RECORD = {16: {"4-path": 122_915_187_566, "4-star": 505_729_627_628,
                      "4-cycle": 1_164_848_010,
                      "4-tailed-triangle": 48_230_073_860,
                      "4-diamond": 3_512_882_086,
                      "4-clique": 291_554_165}}
SGL_DIAMOND_RECORD = {16: 3_512_882_086}
FSM2_MINSUP5000_RECORD = {16: 2, 20: 73}
FSM_K, FSM_MINSUP = 2, 5000       # bench.py:545
SGD_EPOCHS, SGD_STEP = 10, 0.1   # bench.py:290-331
SPMV_REPS = 8             # applies a timed SpMV solve, as bench.py:142
SSSP_DELTA = 1024         # bench.py:335-369
SOURCES = 128             # msbfs and bc: sources 0..127, as bench.py takes
BC_WARMUP, BC_ITERS = 1, 2
# pr and cc: untimed solves (layout build, upload), then timed solves
WARMUP, ITERS = 1, 3
TC_WARMUP, TC_ITERS = 1, 2    # tc, sssp, mst, scc: as bench.py does


def get_graph(scale: int):
    """Symmetrized Graph500 R-MAT graph of 2^scale vertices, degree 16."""
    from gardenia_tpu_torch.core.generate import generate_graph
    return generate_graph("rmat", scale=scale, degree=16, symmetrize=True)


def get_graph_directed(scale: int):
    """Directed Graph500 R-MAT graph of 2^scale vertices, degree 16, with
    its reverse view (bench.py:58)."""
    from gardenia_tpu_torch.core.generate import generate_graph
    return generate_graph("rmat", scale=scale, degree=16, symmetrize=False,
                          need_reverse=True)


def device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def bench_pr(scale: int, device="cuda", g=None):
    """(record, graph, last PRResult) of the PR benchmark; g, when given,
    is the graph get_graph(scale) returns."""
    from gardenia_tpu_torch.solvers.pr import pr_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    res, secs = time_op(lambda: pr_solver(g, device=dev), warmup=WARMUP,
                        iters=ITERS, device=dev)
    gteps = g.nnz * res.iterations / secs / 1e9
    record = {"metric": f"pr_pull_gteps_rmat{scale}",
              "value": gteps, "unit": "GTEPS",
              "vs_baseline": gteps / BASELINE_GTEPS,
              "detail": {"iters": res.iterations,
                         "ms": secs * 1e3, "nnz": g.nnz,
                         "m": g.m, "device": device_name(dev)}}
    return record, g, res


def bench_tc(scale: int, device="cuda", g=None):
    """(record, graph, triangle count) of the TC benchmark; g, when given,
    is the graph get_graph(scale) returns."""
    from gardenia_tpu_torch.solvers.tc import tc_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    total, secs = time_op(lambda: tc_solver(g, device=dev),
                          warmup=TC_WARMUP, iters=TC_ITERS, device=dev)
    meps = g.nnz / secs / 1e6
    record = {"metric": f"tc_meps_rmat{scale}", "value": meps,
              "unit": "M edges/s", "vs_baseline": meps / BASELINE_TC_MEPS,
              "detail": {"triangles": int(total),
                         "ms": secs * 1e3, "nnz": g.nnz,
                         "m": g.m, "device": device_name(dev)}}
    return record, g, total


def bench_cc(scale: int, device="cuda", g=None):
    """(record, graph, last CCResult) of the CC benchmark (bench.py:
    236-250); g, when given, is the graph get_graph(scale) returns."""
    from gardenia_tpu_torch.ops import minselect
    from gardenia_tpu_torch.solvers.cc import cc_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    before = minselect.LAUNCHES
    res, secs = time_op(lambda: cc_solver(g, variant="sv", device=dev),
                        warmup=WARMUP, iters=ITERS, device=dev)
    ms_per_medge = secs * 1e3 / (g.nnz / 1e6)
    record = {"metric": f"cc_sv_ms_rmat{scale}", "value": secs * 1e3,
              "unit": "ms",
              "vs_baseline": BASELINE_CC_MS_PER_MEDGE / ms_per_medge,
              "detail": {"rounds": res.iterations, "nnz": g.nnz, "m": g.m,
                         "device": device_name(dev),
                         "k2_launches": minselect.LAUNCHES - before}}
    return record, g, res


def _k1_launches(before):
    """K1's launches since `before`, a copy of panel.LAUNCHES."""
    since = {k: n - before[k] for k, n in panel.LAUNCHES.items()}
    return {"k1_launches": sum(since.values()),
            "k1_tc_launches": since["tc"]}


def bench_bfs(scale: int, device="cuda", g=None):
    """(record, graph, last BFSResult) of the single-source BFS benchmark
    (bench.py:191-213): bfs_do_fused from the vertex of highest degree, a
    deterministic well-connected source (R-MAT leaves some low ids
    isolated)."""
    import numpy as np
    from gardenia_tpu_torch.solvers.bfs import bfs_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    src = int(np.argmax(g.degrees))
    before = dict(panel.LAUNCHES)
    res, secs = time_op(lambda: bfs_solver(g, src, variant="do_fused",
                                           device=dev),
                        warmup=WARMUP, iters=ITERS, device=dev)
    gteps = g.nnz / secs / 1e9
    record = {"metric": f"bfs_dofused_gteps_rmat{scale}", "value": gteps,
              "unit": "GTEPS", "vs_baseline": gteps / BASELINE_BFS_GTEPS,
              "detail": {"levels": res.iterations, "source": src,
                         "relax_gteps": g.nnz * res.iterations / secs / 1e9,
                         "ms": secs * 1e3, "nnz": g.nnz, "m": g.m,
                         "device": device_name(dev), **_k1_launches(before)}}
    return record, g, res


def bench_msbfs(scale: int, device="cuda", g=None, sources: int = SOURCES):
    """(record, graph, last BFSResult) of the multi-source BFS benchmark
    (bench.py:216-233): aggregated TEPS over S concurrent sources, each
    source's traversal counting nnz edges."""
    import numpy as np
    from gardenia_tpu_torch.solvers.bfs import bfs_multi_source
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    srcs = np.arange(sources)
    before = dict(panel.LAUNCHES)
    res, secs = time_op(lambda: bfs_multi_source(g, srcs, device=dev),
                        warmup=WARMUP, iters=ITERS, device=dev)
    gteps = g.nnz * sources / secs / 1e9
    record = {"metric": f"msbfs{sources}_gteps_rmat{scale}", "value": gteps,
              "unit": "GTEPS", "vs_baseline": gteps / BASELINE_BFS_GTEPS,
              "detail": {"sources": sources, "levels": res.iterations,
                         "ms": secs * 1e3, "nnz": g.nnz, "m": g.m,
                         "device": device_name(dev), **_k1_launches(before)}}
    return record, g, res


def bench_bc(scale: int, device="cuda", g=None, sources: int = SOURCES):
    """(record, graph, last BCResult) of the batched Brandes benchmark
    (bench.py:269-285)."""
    import numpy as np
    from gardenia_tpu_torch.solvers.bc import bc_batched
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    srcs = np.arange(sources)
    before = dict(panel.LAUNCHES)
    res, secs = time_op(lambda: bc_batched(g, srcs, device=dev),
                        warmup=BC_WARMUP, iters=BC_ITERS, device=dev)
    # Brandes traverses each edge twice (forward + backward) per source
    gteps = 2 * g.nnz * sources / secs / 1e9
    record = {"metric": f"bc_batched{sources}_gteps_rmat{scale}",
              "value": gteps, "unit": "GTEPS",
              "vs_baseline": gteps / BASELINE_BC_GTEPS,
              "detail": {"sources": sources, "levels": res.iterations,
                         "ms": secs * 1e3, "nnz": g.nnz, "m": g.m,
                         "device": device_name(dev), **_k1_launches(before)}}
    return record, g, res


def spmv_applies(g, device, reps: int = SPMV_REPS) -> torch.Tensor:
    """The SpMV bench's solve: a power loop of `reps` hybrid applies, each
    normalized by max|y|, from x = 0.3, on the PR layout with scale 0.2 —
    the reference's uniform 0.2 values (src/spmv/main.cc) factor into its
    int8 count panels, so no second layout is built (bench.py:155-166)."""
    import dataclasses
    from gardenia_tpu_torch.core import views
    from gardenia_tpu_torch.ops.bsr import spmv_hybrid
    g2, hyb, _ = views.relabeled_hybrid(g, device)
    hyb = dataclasses.replace(hyb, scale=0.2)
    x = torch.full((g2.n,), 0.3, dtype=torch.float32, device=device)
    for _ in range(reps):
        y = spmv_hybrid(hyb, x, num_rows=g2.m)
        x = y / y.abs().max().clamp(min=1e-30)
    return x


def bench_spmv(scale: int, device="cuda", g=None, reps: int = SPMV_REPS):
    """(record, graph, last normalized y) of the SpMV benchmark
    (bench.py:142-183), in GFLOP/s of one apply."""
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    before = dict(panel.LAUNCHES)
    y, secs = time_op(lambda: spmv_applies(g, dev, reps), warmup=WARMUP,
                      iters=ITERS, device=dev)
    per = secs / reps
    gflops = 2 * g.nnz / per / 1e9
    record = {"metric": f"spmv_gflops_rmat{scale}", "value": gflops,
              "unit": "GFLOP/s", "vs_baseline": gflops / BASELINE_SPMV_GFLOPS,
              "detail": {"ms_per_apply": per * 1e3, "reps": reps,
                         "nnz": g.nnz, "m": g.m, "device": device_name(dev),
                         **_k1_launches(before)}}
    return record, g, y


def sssp_graph(scale: int):
    """The SSSP benchmark's graph: the symmetrized grid of side
    2^(scale // 2), with its reverse CSR (bench.py:335-369)."""
    from gardenia_tpu_torch.core.generate import grid_edges
    from gardenia_tpu_torch.core.graph import from_edges
    return from_edges(grid_edges(1 << (scale // 2)), symmetrize=True,
                      need_reverse=True)


def bench_sssp(scale: int, device="cuda"):
    """(record, graph, last SSSPResult) of the SSSP benchmark
    (bench.py:335-369): near-far delta-stepping on the weighted grid, the
    road-network stand-in; side = 2^(scale // 2)."""
    from gardenia_tpu_torch.solvers.sssp import sssp_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    side = 1 << (scale // 2)
    g = sssp_graph(scale)
    res, secs = time_op(lambda: sssp_solver(g, 0, SSSP_DELTA,
                                            variant="nearfar", device=dev),
                        warmup=TC_WARMUP, iters=TC_ITERS, device=dev)
    gteps = g.nnz / secs / 1e9
    record = {"metric": f"sssp_nf_gteps_grid{side}", "value": gteps,
              "unit": "GTEPS", "vs_baseline": gteps / BASELINE_SSSP_GTEPS,
              "detail": {"rounds": res.iterations, "ms": secs * 1e3,
                         "nnz": g.nnz, "m": g.m, "delta": SSSP_DELTA,
                         "device": device_name(dev)}}
    return record, g, res


def mst_graph(g):
    """g with the integer weights of bench.py:473-497: w(u, v) = w(v, u) =
    (lo * 2654435761 + hi * 40503) % 97 + 1 for the pair's ids lo < hi."""
    import numpy as np
    from gardenia_tpu_torch.core.graph import Graph
    src = np.repeat(np.arange(g.m, dtype=np.int64), np.diff(g.rowptr))
    dst = np.asarray(g.colidx, np.int64)
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    w = ((lo * 2654435761 + hi * 40503) % 97 + 1).astype(np.float64)
    return Graph(g.rowptr, g.colidx, w, num_cols=g.n, symmetric=True)


def bench_mst(scale: int, device="cuda", g=None):
    """(record, weighted graph, last MSTResult) of the MST benchmark
    (bench.py:473-497); g, when given, is the graph get_graph(scale)
    returns."""
    from gardenia_tpu_torch.solvers.mst import mst_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    gw = mst_graph(get_graph(scale) if g is None else g)
    res, secs = time_op(lambda: mst_solver(gw, device=dev),
                        warmup=TC_WARMUP, iters=TC_ITERS, device=dev)
    ms_per_medge = secs * 1e3 / (gw.nnz / 1e6)
    record = {"metric": f"mst_boruvka_ms_rmat{scale}", "value": secs * 1e3,
              "unit": "ms",
              "vs_baseline": BASELINE_MST_MS_PER_MEDGE / ms_per_medge,
              "detail": {"weight": res.total_weight,
                         "tree_edges": int(res.edge_mask.sum()),
                         "nnz": gw.nnz, "m": gw.m,
                         "device": device_name(dev)}}
    return record, gw, res


def bench_scc(scale: int, device="cuda", g=None):
    """(record, directed graph, last SCCResult) of the SCC benchmark
    (bench.py:456-470); g, when given, is get_graph_directed(scale)."""
    import numpy as np
    from gardenia_tpu_torch.solvers.scc import scc_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph_directed(scale)
    res, secs = time_op(lambda: scc_solver(g, device=dev),
                        warmup=TC_WARMUP, iters=TC_ITERS, device=dev)
    ms_per_medge = secs * 1e3 / (g.nnz / 1e6)
    record = {"metric": f"scc_ms_rmat{scale}d", "value": secs * 1e3,
              "unit": "ms",
              "vs_baseline": BASELINE_SCC_MS_PER_MEDGE / ms_per_medge,
              "detail": {"sccs": len(np.unique(res.scc_root.cpu().numpy())),
                         "rounds": res.iterations, "nnz": g.nnz, "m": g.m,
                         "device": device_name(dev)}}
    return record, g, res


def bench_vc(scale: int, device="cuda", g=None):
    """(record, graph, last VCResult) of the VC benchmark (bench.py:
    442-452); g, when given, is the graph get_graph(scale) returns."""
    from gardenia_tpu_torch.ops import vc_core
    from gardenia_tpu_torch.solvers.vc import vc_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    before = vc_core.LAUNCHES
    res, secs = time_op(lambda: vc_solver(g, device=dev), warmup=WARMUP,
                        iters=ITERS, device=dev)
    ms_per_medge = secs * 1e3 / (g.nnz / 1e6)
    record = {"metric": f"vc_ms_rmat{scale}", "value": secs * 1e3,
              "unit": "ms",
              "vs_baseline": BASELINE_VC_MS_PER_MEDGE / ms_per_medge,
              "detail": {"num_colors": res.num_colors,
                         "rounds": res.iterations,
                         "rounds_by_tier": res.rounds,
                         "palette": res.palette,
                         "core_size": res.core_size,
                         "v1_launches": vc_core.LAUNCHES - before,
                         "nnz": g.nnz, "m": g.m,
                         "device": device_name(dev)}}
    return record, g, res


def bench_symgs(scale: int, device="cuda", g=None):
    """(record, graph, last SymGSResult) of the SymGS benchmark (bench.py:
    500-522); the colouring is set-up, not timed."""
    from gardenia_tpu_torch.solvers.symgs import default_inputs, symgs_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    inputs = default_inputs(g, dev)
    res, secs = time_op(lambda: symgs_solver(g, *inputs, device=dev),
                        warmup=WARMUP, iters=ITERS, device=dev)
    gflops = 4 * g.nnz / secs / 1e9
    record = {"metric": f"symgs_gflops_rmat{scale}", "value": gflops,
              "unit": "GFLOP/s",
              "vs_baseline": gflops / BASELINE_SYMGS_GFLOPS,
              "detail": {"ms": secs * 1e3, "colors": res.num_colors,
                         "nnz": g.nnz, "m": g.m,
                         "device": device_name(dev)}}
    return record, g, res


def sgd_graph(g):
    """g with ratings integers(1, 6) from default_rng(13) as its weights
    (bench.py:306-314), a new Graph over the same CSR."""
    import numpy as np
    from gardenia_tpu_torch.core.graph import Graph
    rng = np.random.default_rng(13)
    return Graph(g.rowptr, g.colidx,
                 rng.integers(1, 6, g.nnz).astype(np.float64),
                 num_cols=g.n, symmetric=g.symmetric)


def sgd_init(g, device):
    """The latent tables init_latent(m, 0), init_latent(n, 1) on device."""
    from gardenia_tpu_torch.solvers.sgd import init_latent, num_items
    return (torch.from_numpy(init_latent(g.m, 0)).to(device),
            torch.from_numpy(init_latent(num_items(g), 1)).to(device))


def bench_sgd(scale: int, device="cuda", g=None, epochs: int = SGD_EPOCHS):
    """(record, rating graph, last SGDResult) of the SGD benchmark
    (bench.py:290-331); g, when given, is the graph get_graph(scale)
    returns, under the benchmark's ratings."""
    from gardenia_tpu_torch.solvers.sgd import sgd_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    gr = sgd_graph(get_graph(scale) if g is None else g)
    init = sgd_init(gr, dev)
    res, secs = time_op(lambda: sgd_solver(gr, step=SGD_STEP,
                                           max_iters=epochs, epsilon=0.0,
                                           init=init, device=dev),
                        warmup=TC_WARMUP, iters=TC_ITERS, device=dev)
    mrps = gr.nnz * epochs / secs / 1e6
    trace = res.rmse.cpu().tolist()[:res.iterations]
    record = {"metric": f"sgd_mf_mrps_rmat{scale}", "value": mrps,
              "unit": "M ratings/s", "vs_baseline": mrps / BASELINE_SGD_MRPS,
              "detail": {"epochs": epochs, "ms": secs * 1e3,
                         "final_rmse": trace[-1], "rmse": trace,
                         "nnz": gr.nnz, "m": gr.m,
                         "device": device_name(dev)}}
    return record, gr, res


def mining_repeats(scale: int) -> dict:
    """A mining bench's repeats (bench.py:383-385): one warm-up solve,
    then one timed solve at scale >= 18 (a solve is long there), two
    below."""
    return {"warmup": 1, "iters": 2 if scale < 18 else 1}


def bench_kcl(scale: int, device="cuda", g=None, k: int = 4):
    """(record, graph, clique count) of the kCL benchmark (bench.py:
    376-393); g, when given, is the graph get_graph(scale) returns."""
    from gardenia_tpu_torch.mining import kcl
    from gardenia_tpu_torch.ops import kcl_count
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    before = kcl_count.LAUNCHES
    total, secs = time_op(lambda: kcl.kcl_solver(g, k, device=dev),
                          device=dev, **mining_repeats(scale))
    route, launches = kcl.LAST_ROUTE, kcl_count.LAUNCHES - before
    record_count = KCL4_RECORD.get(scale) if k == 4 else None
    if record_count is not None:
        check, correct = "record", total == record_count and route == "q1"
    elif g.m <= 5000:
        check, correct = "verifier", total == kcl.kcl_verifier(g, k)
    else:
        check = "plain"
        correct = total == int(kcl_count.local_count_plain(
            kcl.local_dag(g, dev), k).sum())
    mcps = total / secs / 1e6
    record = {"metric": f"kcl{k}_mcps_rmat{scale}", "value": mcps,
              "unit": "M cliques/s", "vs_baseline": mcps / BASELINE_KCL4_MCPS,
              "detail": {"cliques": int(total), "k": k, "ms": secs * 1e3,
                         "route": route, "q1_launches": launches,
                         "check": check, "correct": bool(correct),
                         "nnz": g.nnz, "m": g.m, "device": device_name(dev)}}
    return record, g, total


def bench_motif(scale: int, device="cuda", g=None):
    """(record, graph, census) of the 4-motif benchmark (bench.py:396-408);
    g, when given, is the graph get_graph(scale) returns."""
    from gardenia_tpu_torch.mining import kcl, motif, wedgestream
    from gardenia_tpu_torch.ops import kcl_count
    from gardenia_tpu_torch.solvers.tc import tc_solver
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    before = kcl_count.LAUNCHES
    census, secs = time_op(lambda: motif.motif_solver(g, 4, device=dev),
                           device=dev, **mining_repeats(scale))
    route, launches = kcl.LAST_ROUTE, kcl_count.LAUNCHES - before
    agg = motif.LAST_AGGREGATES
    if scale in MOTIF4_RECORD:
        check = "record"
        correct = census == MOTIF4_RECORD[scale] and route == "q1"
    elif scale in KCL4_RECORD:
        check = "record"
        correct = (census["4-clique"] == KCL4_RECORD[scale]
                   and agg["tri_sum"] == 3 * TC_RECORD[scale]
                   and agg["aggregates"] == "streams" and route == "q1")
    else:
        check = "solvers"
        correct = (census["4-clique"] == kcl.kcl_solver(g, 4, device=dev)
                   and agg["tri_sum"] == 3 * tc_solver(g, device=dev))
    meps = g.nnz / secs / 1e6
    record = {"metric": f"motif4_meps_rmat{scale}", "value": meps,
              "unit": "M edges/s", "vs_baseline": meps / BASELINE_MOTIF4_MEPS,
              "detail": {"census": census, "ms": secs * 1e3,
                         "aggregates": agg["aggregates"],
                         "kcl_route": route, "q1_launches": launches,
                         **wedgestream.partition_counts(g),
                         "check": check, "correct": bool(correct),
                         "nnz": g.nnz, "m": g.m, "device": device_name(dev)}}
    return record, g, census


def bench_sgl(scale: int, device="cuda", g=None):
    """(record, graph, diamond count) of the SGL benchmark (bench.py:
    525-542); g, when given, is the graph get_graph(scale) returns."""
    from gardenia_tpu_torch.mining import sgl
    from gardenia_tpu_torch.ops import kcl_count
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    before = kcl_count.LAUNCHES
    total, secs = time_op(lambda: sgl.sgl_solver(g, "diamond", device=dev),
                          device=dev, **mining_repeats(scale))
    launches = kcl_count.LAUNCHES - before
    last = sgl.LAST_ROUTE
    if scale in SGL_DIAMOND_RECORD:
        check = "record"
        correct = (total == SGL_DIAMOND_RECORD[scale]
                   and last["kcl_route"] == "q1")
    elif scale in KCL4_RECORD:
        check = "record"
        correct = (last["k4"] == KCL4_RECORD[scale]
                   and last["tri_sum"] == 3 * TC_RECORD[scale]
                   and last["route"] == "streams"
                   and last["kcl_route"] == "q1")
    elif g.m <= 40:
        check, correct = "verifier", total == sgl.sgl_verifier(g, "diamond")
    else:
        check = "engine"
        correct = total == sgl.sgl_solver(g, "diamond", use_formula=False,
                                          device=dev)
    meps = g.nnz / secs / 1e6
    record = {"metric": f"sgl_diamond_meps_rmat{scale}", "value": meps,
              "unit": "M edges/s", "vs_baseline": meps / BASELINE_SGL_MEPS,
              "detail": {"count": int(total), "ms": secs * 1e3,
                         "route": last["route"],
                         "kcl_route": last["kcl_route"],
                         "q1_launches": launches,
                         "check": check, "correct": bool(correct),
                         "nnz": g.nnz, "m": g.m, "device": device_name(dev)}}
    return record, g, total


def bench_fsm(scale: int, device="cuda", g=None):
    """(record, graph, count) of the FSM benchmark (bench.py:545-566) at
    k = FSM_K, minsup FSM_MINSUP, on the degree-bucket labels; g, when
    given, is the graph get_graph(scale) returns."""
    from gardenia_tpu_torch.mining import fsm_agg
    from gardenia_tpu_torch.mining.fsm import fsm_solver
    from gardenia_tpu_torch.mining.gspan import fsm_gspan
    from gardenia_tpu_torch.utils.timer import time_op
    dev = resolve_device(device)
    if g is None:
        g = get_graph(scale)
    before = dict(panel.LAUNCHES)
    split_before = panel.SPLIT_LAUNCHES["split"]
    total, secs = time_op(
        lambda: fsm_solver(g, FSM_K, FSM_MINSUP, device=dev), warmup=1,
        iters=1, device=dev)
    k1 = {r: n - before[r] for r, n in panel.LAUNCHES.items()}
    split = panel.SPLIT_LAUNCHES["split"] - split_before
    if scale in FSM2_MINSUP5000_RECORD:
        check = "record"
        correct = total == FSM2_MINSUP5000_RECORD[scale]
    else:
        check = "gspan"
        correct = total == fsm_gspan(g, FSM_K, FSM_MINSUP, device=dev)
    L = fsm_agg.label_ids(g)[1]
    meps = g.nnz / secs / 1e6
    record = {"metric": f"fsm{FSM_K}_minsup{FSM_MINSUP}_meps_rmat{scale}",
              "value": meps, "unit": "M edges/s",
              "vs_baseline": meps / BASELINE_FSM_MEPS,
              "detail": {"frequent_patterns": int(total), "k": FSM_K,
                         "minsup": FSM_MINSUP, "ms": secs * 1e3, "labels": L,
                         "lane_chunks": len(fsm_agg.lane_chunks(L)),
                         "k1_launches": k1, "split_launches": split,
                         "check": check, "correct": bool(correct),
                         "nnz": g.nnz, "m": g.m, "device": device_name(dev)}}
    return record, g, total


KERNELS = {"pr": bench_pr, "tc": bench_tc, "cc": bench_cc, "bfs": bench_bfs,
           "msbfs": bench_msbfs, "bc": bench_bc, "spmv": bench_spmv,
           "sssp": bench_sssp, "mst": bench_mst, "scc": bench_scc,
           "vc": bench_vc, "symgs": bench_symgs, "sgd": bench_sgd,
           "kcl": bench_kcl, "motif": bench_motif, "sgl": bench_sgl,
           "fsm": bench_fsm}


def parse_args(argv=None) -> argparse.Namespace:
    """The bench's flags; --quick sets the scale to 16 (bench.py:582-585)."""
    ap = argparse.ArgumentParser(prog="python -m gardenia_tpu_torch.bench")
    ap.add_argument("--kernel", default="pr", choices=sorted(KERNELS))
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--quick", action="store_true",
                    help="scale 16 for smoke runs")
    args = ap.parse_args(argv)
    if args.quick:
        args.scale = 16
    return args


def main(argv=None):
    args = parse_args(argv)
    t0 = time.time()
    record, _, _ = KERNELS[args.kernel](args.scale, args.device)
    record["detail"]["total_s"] = time.time() - t0
    print(json.dumps(record))


if __name__ == "__main__":
    main()
