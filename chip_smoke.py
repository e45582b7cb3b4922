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
     pull PageRank on R-MAT-20 over "auto"'s layout on the card, the
     relabelled ELL — generate, relabel, build_ell, upload, pr_solver on
     cuda — with K1's launches (none) and E1's (one an iteration) read
     around it; one "auto" and one layout="hybrid" solve, each with its
     K1 (iterations x panel arrays for hybrid) and E1 launches and the
     oracle's residual; E1 (spmv_ell) against spmv_ell_plain, within 1e-6
     relative, and timed beside its bytes bound, on the hybrid layout's
     remainder and on the whole relabelled ELL layout that "auto" applies;
     one spmv_hybrid apply timed with K1 and with the plain version; the
     library yardstick at S = 1 (one torch.sparse_bsr_tensor product over
     the whole dense part);
  5. triangle counting's kernels K3 (rot_count), K4 (merge_count, with
     its class width W) and H1 (bitmap_count) against their plain
     versions on the card, pair by pair with exact integer equality, in
     every width class of the R-MAT-16 streams as uploaded (ordered by
     the shared row) and on a seeded random permutation of each, K3 and
     K4 each on every class (the routes that MERGE_MIN_W = 256 and 8
     take), and on small edge-case streams (one pair, runs across and
     longer than a kernel's block of pairs as the library reports it,
     lengths no multiple of it or of the pairs a K3 warp or CTA takes at
     once, all-pad rows and the sentinel row on either side, all-zero hub
     rows, a bitmap row wider than H1's shared tile); then tc_solver on
     R-MAT-16 (rotate under the three routings, and bsearch) against the
     serial oracle;
  6. the TC main path: the port's bench (--kernel tc) on phase 4's
     R-MAT-20 graph — orient, host prep, upload, tc_solver on cuda — with
     the launch counts of K3, K4 and H1 read around it (classes x
     solves), the count held to the JAX package's 424,573,866 and to the
     plain route's and tc_bsearch's counts; every stream held to the
     plain versions as in phase 5 (uploaded and shuffled); then per
     routed class the kernel against its plain version (pairs, ms in
     turns plain/kernel/kernel/plain, GB/s of the rows its design reads)
     and peak device memory; K3 and K4 timed beside each other on every
     class (the crossover that solvers/tc.MERGE_MIN_W is set by);
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
  9. kernel K1 at the batched shape (the tensor-core kernel,
     csrc/dense_panel_matmul_tc.cu: wgmma on TMA-staged tiles fed by a
     producer warp) against its plain version on the card: every panel
     array of the R-MAT-16 layout and of the f32- and bf16-panel weighted
     layouts (f32 panels take the CUDA-core kernel at any S) at S = 16,
     100, 128, 136 and 256 (two column tiles), with a random f32 operand
     (limit max|diff| / max|y| < 1e-5), a random bf16 operand (one bf16
     pass: limit 1e-4) and a 0/1 bf16 mask (exact on integer panels: 0
     mismatching elements); edge cases R = 1 and W = 1, a slot whose
     blocks are all zero, the widest slot with one cell a block, a bf16
     panel array, at S = 9, 16, 100, 128, 136, 256; then the R-MAT-20
     panels at S = 128 with both operand types, and the worst relative
     error on the W = 32 arrays per operand type; the f32 operand's split
     into three bf16 terms (split_operand's kernel) held to its plain
     version exactly;
  10. BFS, multi-source BFS and Brandes BC on R-MAT-16: bfs pull, do and
     do_fused on both layouts with depths exactly the serial oracle's;
     bfs_multi_source (16 sources, both layouts) column by column against
     the single-source solver; bc_solver against the serial oracle and a
     level-synchronous numpy Brandes written here, and bc_batched (16
     sources, both layouts) against that reference summed over the
     sources, within the CLI's tolerance;
  11. the BFS / MS-BFS / BC main path at R-MAT-20: the port's bench for
     bfs, msbfs (128 sources) and bc (128 sources), each with K1's launch
     counts set to 0 before and read after (msbfs: levels x panel arrays a
     solve, all by the tensor-core kernel; bc: 2 x levels x arrays;
     bfs: dense-sweep levels x arrays, by the CUDA-core kernel);
     bfs_do_fused's depths held to the serial oracle, multi-source BFS's
     128 columns to a numpy bitset BFS on the host CSR (and its first 8
     columns, with that BFS's, to scipy's breadth-first order), batched
     BC to its panel-free 'ell' route and two of its sources to the numpy
     Brandes; one spmv_hybrid_batched apply timed with CUDA events in
     turns (plain, kernel, kernel, plain): the panel kernel alone with
     both operand types (the f32 operand's split included, and alone),
     the library yardstick (one torch.sparse_bsr_tensor product over the
     whole dense part, f32 and bf16 values, held to the kernel's sweep plus
     the slot index_add_), the CUDA-core kernel at S = 128 beside it, the
     remainder alone (segment_reduce, and index_add_ beside it), the
     whole apply; the bytes the design reads; single-source BFS on the
     ell layout beside the hybrid one; peak device memory of the BC solve;
  12. cc_sv with layout="ell" beside "hybrid" on R-MAT-20 and uniform-14:
     the first solve of a fresh graph object (relabel, upload, and the
     layout where a round is dense) in seconds and the best of three
     later solves in ms, one line each; and what building the hybrid
     layout at the first solve would add (the layout's build alone).
  13. SpMV: K1 against its plain version (S = 1) in every panel array of
     the SpMV solver's threshold-64 layouts (directed R-MAT-16 with the
     uniform 0.2: int8 counts x scale; the weighted f32 and bf16
     graphs); every variant (ell, hybrid, segment, push_pb on the
     transpose, auto) against the serial product within sqrt(eps) of
     f32; the main path: the port's bench (--kernel spmv) at R-MAT-20 on
     phase 4's layout, K1's launches set to 0 before and read after
     (reps x panel arrays x solves, all by the CUDA-core kernel), its
     power loop held to scipy's in f64; one apply of the PR layout timed
     with CUDA events beside ELL-only applies (original and relabelled
     ids);
  14. SSSP: bf, delta, hybrid and nearfar on weighted R-MAT-16 against
     the serial Dijkstra, exactly, with kernel F1's launches (one a
     sparse round: launches.relax = sssp.rounds_sparse; none in
     nearfar); the port's bench (--kernel sssp, nearfar on the weighted
     grid of side 1024) with its rounds, its distances equal to scipy's
     Dijkstra; F1 (ops/relax.sparse_relax) against its plain version,
     exactly, on every sparse round of a delta-stepping solve on
     kron20w (graphbench's configuration at scale 20), and timed beside
     its bytes bound and the plain version on the widest and the median
     of those rounds;
  15. the port's MST bench at R-MAT-20, its weight equal to scipy's
     minimum_spanning_tree; the SCC bench on the directed R-MAT-20
     ('color') and the 'wcc' variant, each a bijection with scipy's
     strong components; cluster_threshold (unweighted, and weighted at
     threshold 128) against scipy's components and random_walks (every
     step an out-edge or a sink staying put, the seed repeating the
     walks) at R-MAT-16;
  16. vertex colouring: kernel V1 (the core pass's sequential first-fit,
     along the order's dependency DAG) against its plain loop, exactly, on
     hand-made cases (K = 1, a saturated row with C = 4, an empty
     adjacency, cliques wider and narrower than the palette, first zeros
     past the pulled colours, C = 20 and 16384, a K no multiple of the
     grid's warps, a chain), on the R-MAT-16 core
     (the whole graph, K = 65,536), the first core pass of R-MAT-20's
     first solve (C 128, rows saturating) and the core pass of the
     R-MAT-20 bench's last solve (at the palette the graph remembers);
     vc_solver at R-MAT-16 and R-MAT-20 held to vc_check, and at R-MAT-16
     to the whole solve with the plain loop in place of V1 (colours and
     rounds equal) and, with the tiers forced (VC_FORCED_TIERS), to the
     same solve on the CPU; the port's bench (--kernel vc) at R-MAT-20
     with V1's launches set to 0 before and read after, rounds by tier,
     palette and peak device memory; 20 more launches of V1 on the bench's
     core, all equal; V1's ms on the bench's core and the R-MAT-16 core
     beside its plain loop's, its bytes bound, the depth D of the core's
     DAG and V1 on a chain of D positions (the floor of D hand-overs);
  17. SymGS at R-MAT-16 against the serial sweep; the bench (--kernel
     symgs) at R-MAT-20 against an independent float64 sweep of scipy's
     colour-ordered CSR; each within the CLI's l2 < 1e-4 and an f32
     sweep's 1e-10 (SYMGS_F64_L2), on colours held proper by vc_check;
     kernel GS1 (one launch a colour block) at hpcg20's shape, held to
     its plain version block by block (1e-6 relative), symgs_solver on
     the same inputs against the plain route's x, and timed: one
     application's launches beside the plain sweep, its
     torch.segment_reduce calls alone and the bytes bound; GS1's
     launches set to 0 before each of the three solver paths (R-MAT-16,
     the R-MAT-20 bench, hpcg20) and read after, each one a colour block
     of each half of each solve;
  18. SGD at R-MAT-16, 4 epochs, trace and factors against a float64
     numpy/scipy replica of the epoch; the bench (--kernel sgd) at
     R-MAT-20, 10 epochs, its trace finite and monotone, its final RMSE
     beside the TPU record's;
  19. k-clique counting: kernel Q1 (per-vertex counts in each vertex's
     local bitmap graph) -- its sizes (hash table bits and slots, lanes a
     root, shared bytes) held to the host's copies in ops/kcl_count at
     every out-degree 1..1024 -- against its plain version (the level
     expansion) vertex by vertex, exactly, at k = 3, 4 and 5 on hand-made
     cases (no edge; cliques, also against C(n-1-u, k-1), and K_12, K_34
     at k = 6..8; K_{n,n} with random edges inside one side, whose other
     side has out-degree exactly n: 32/33 (one and two words a row in
     the warp shape), 64/65 (the warp shape's edge), 128/129 and 256/257
     (where the lanes a root change; 257 the tensor cores' first W),
     512/513 (the hubs' run), 1024 and 1025, which must take the
     expansion; one hub of out-degree 1024 alone in the CTA shape;
     out-neighbours that all share the table's last slot, at d = 60 and
     500, with ids in their rows that pass the filter and miss), on
     R-MAT-16 at k = 3 and 4 and on R-MAT-14 at k = 5; kcl_solver at
     R-MAT-16 against the TPU record (291,554,165); the main path: the
     port's bench (--kernel kcl) at R-MAT-20, Q1's launches set to 0
     before and read after (the launch plan's runs x solves), its count
     held to the TPU record (17,113,600,315) on route q1; k = 3 through
     Q1 (force_expand) against tc_solver at R-MAT-16 and R-MAT-20; Q1
     timed by CUDA events at R-MAT-20 and R-MAT-16 beside one call of the
     plain version (held equal per vertex), and its bound (the CSR,
     vertex lists and counts once; the smaller side's membership tests
     and the word ANDs); per degree class, Q1 and the copies of
     scripts/probe_q1.py without the count and without the lookups;
  20. the motif census: the port's bench (--kernel motif) at R-MAT-16,
     its census equal to the TPU record; the wedge streams' per-edge
     triangles against the card's wedge sweep at R-MAT-16 and R-MAT-14
     and their 4-cycles against the numpy codegree sort at R-MAT-14; the
     3-census at R-MAT-20; the bench at R-MAT-20, its 4-cliques equal to
     kcl's record and its triangles over the edges 3 x 424,573,866; the
     host-oracle branch must not run.
  21. subgraph listing: the port's bench (--kernel sgl, diamond) at
     R-MAT-16 against the TPU record (3,512,882,086); the main path: the
     bench at R-MAT-20 on [20]'s graph (its wedge streams cached there),
     Q1's launches set to 0 before and read after (runs x solves), its
     count held to the port's 4-census (280,503,420,577) and [20]'s, on
     the streams and route q1; the pattern engine on the card: diamond
     against the formula and rectangle against the 4-census's 4-cycles at
     R-MAT-12, pentagon and house at R-MAT-10 against dense 0/1
     products (induced_fives) and at R-MAT-8 against CPU tensors, every
     pattern against sgl_verifier on a 30-vertex graph;
  22. frequent-subgraph mining: the port's bench (--kernel fsm, k = 2,
     minsup 5000) at R-MAT-16 against the TPU record (2), its five label
     aggregates against scipy's on the host CSR; the main path: the bench
     at R-MAT-20 (the record: 73), K1's launches by route and the
     split's set to 0 before and read after (applies x panel arrays x
     solves, all 'tc'; no split), its aggregates against the panel-free
     route (ops/spmv.spmv_batched over the CSR, which launches no K1);
     K1 on the bench's bf16 0/1 operands (S = L = 11, S = L * L = 121)
     against its plain version, exactly, and timed by CUDA events beside
     it, its bound and the library yardstick (torch.sparse_bsr_tensor with
     f32 values @ the operand, beside K1 + the slot index_add_); fsm_solver
     at k = 2 and 3 (gSpan) at R-MAT-9 with 16 seeded random labels, minsup
     16, on the card against CPU tensors.  Phases 21 and 22 print the peak
     device memory.
  23. the multi-device path (gardenia_tpu_torch/parallel, one process a
     rank started by parallel.mesh.run_on_ranks): pr_solver_dist on one
     rank (nccl) at R-MAT-20, hybrid layout, against the single-device
     pr_solver (scores within 1e-6 and 1e-5 of the largest, the same
     iterations, the residual),
     K1's launches on the rank = iterations x its shard's panel arrays;
     two ranks on the one card (gloo with CUDA tensors): PR at R-MAT-20 as
     above, each rank's K1 launches = iterations x its arrays; at R-MAT-16
     BFS (hybrid and ell) from the vertex of highest degree against the
     serial BFS, MS-BFS-dp with 128 sources (64 a rank, K1's tensor-core
     kernel on each) against the numpy bitset BFS, TC against tc_solver,
     VC proper, SCC (directed) a bijection of scipy's strong components;
     each with its solve ms (the second solve; the first builds the
     shard), its collectives' calls, bytes and ms an iteration (replayed
     alone), the backend; then the CLI's pr rmat 16 --dist=2 (Correct),
     entry()'s step on the card against CPU tensors and the bench's
     --quick (one JSON line at scale 16).  On each rank of the hybrid PR,
     BFS and MS-BFS cases, K1's calls of the first solve are held to its
     plain version on the same shard arrays and operand, and the PR and
     BFS shard's whole apply to scipy's product of the graph's rows.
     K1's launches_by_path gains the dist paths;
  24. the rest of the multi-device layer, in phase 23's two groups:
     cc_solver_dist hybrid at R-MAT-20 (a bijection of scipy's
     components; K2 on each rank's shard every round) and
     sssp_solver_dist hybrid, unweighted, from the vertex of highest
     degree (scipy's BFS depths; M1 every round), on one and two ranks;
     M1 timed alone on the one-rank shard beside its plain version, K2 on
     the same panels and its bound; at R-MAT-16 on two ranks CC ell, SSSP
     ell and hybrid on hashed weights (scipy's Dijkstra), SpMV (scipy's
     f64 product), BC hybrid with 128 sources (bc_batched), SymGS
     (symgs_solver), SGD's full-batch steps (an f64 numpy replica), MST
     (scipy's tree weight), and the 1x2 mesh's TC, SCC and VC (tc_solver,
     scipy's SCCs, vc_check); every K2 and M1 call of the first solves
     held exactly to its plain version, their launches in the second =
     rounds x the rank's panel arrays; M1's hand cases (each panel dtype
     and its widest weight, W 1/4/32, scale 1 and 3, -0.0 cells, rows
     with no edge, candidates past the sentinel); dryrun_multichip(2)
     with all 13 of the JAX dryrun's kernels.  The kernels line gains M1
     and K2's dist paths.
`python3 chip_smoke.py --dist-only` runs phases 1, 2, 23 and 24 alone,
without the last two lines: a quick check of a change to the dist path.
The line before the last is a JSON object with every kernel's launches,
error, times and bound (bound_ms: the larger of the bytes each input and
output moves once over 3.35 TB/s and the operations over the card's peak
for their type, non-tensor or dense bf16 tensor, from this run's inputs; a
TC stream's inputs are its index pairs and the distinct rows it refers
to); the last line is {"ok": true, "device": {...}}.

Needs CUDA: without a card, or without the repository around it, it
exits non-zero.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np

SMOKE_SCALE = 16            # K1's width buckets and the oracle check
MAIN_SCALE = 20             # the bench's default graph: |V| = 2^20
CC_UNIFORM_SCALE = 14       # cc_sv takes a dense round there (K2 runs)
K1_REL_LIMIT = 1e-5
# a bf16 operand asks for one bf16 pass: its values carry 2^-9 themselves,
# and its products are summed in the tensor core's accumulator, which
# truncates (measured up to 9e-6 on the densest bf16-panel rows)
K1_BF16_REL_LIMIT = 1e-4
# a rank's whole hybrid shard applied on the card against scipy's f64
# product, max|diff| / max|y|; and the dist PR's scores against the
# single-device solver's, max|diff| / max|score| (beside 1e-6 absolute)
SHARD_REL_LIMIT = 1e-5
DIST_PR_REL_LIMIT = 1e-5
BATCH_SMOKE_SOURCES = 16    # multi-source BFS and BC at R-MAT-16
# the R-MAT-20 MS-BFS's 128 columns are held to a numpy bitset BFS
# (bfs_depths_bits, ~0.1 s a column), and its first columns also to
# scipy's breadth_first_order (~0.45 s a column)
MSBFS_SCIPY_COLUMNS = 8
SSSP_SMOKE_DELTA = 64       # the four SSSP variants at R-MAT-16
K1_BATCH_S = (16, 100, 128, 136, 256)    # 136, 256: two column tiles
K1_EDGE_S = (9, 16, 100, 128, 136, 256)
K1_SOURCE = "gardenia_tpu_torch/csrc/dense_panel_matmul.cu"
K1_TC_SOURCE = "gardenia_tpu_torch/csrc/dense_panel_matmul_tc.cu"
# the f32 operand's split into bf16 terms: an XLA pass of the JAX package
# (no Pallas kernel), a kernel of K1_TC_SOURCE in the port
SPLIT_REPLACES = "gardenia_tpu/ops/bsr.py:319"
K1_REPLACES = "gardenia_tpu/ops/pallas_bsr.py:67"
K2_SOURCE = "gardenia_tpu_torch/csrc/dense_panel_minselect.cu"
K2_REPLACES = "gardenia_tpu/ops/pallas_bsr.py:113"
SENT = 2 ** 31 - 1          # the min-select sentinel (INT32_MAX)
# M1, the min-plus twin of K2 in K2_SOURCE: it replaces the XLA masked
# reduce-min of the JAX package's spmv_hybrid_min_plus (no Pallas kernel)
M1_REPLACES = "gardenia_tpu/ops/bsr.py:488"
# the widest weight each panel dtype holds as build_hybrid fills it: int8
# to 127, bf16 integers to 256; f32 integers are exact to 2^24
M1_TOP_WEIGHTS = ((0, 127), (1, 256), (2, 1 << 24))
# [24]'s dist SGD at R-MAT-16: full-batch steps (the solver's default step
# 0.003 diverges there: a hub's gradient sums thousands of edges)
DIST_SGD_ITERS, DIST_SGD_STEP = 3, 1e-4
# published peaks of one H100 SXM (NVIDIA's H100 datasheet): device
# memory bytes/s; the non-tensor f32 rate, taken for the CUDA-core integer
# and f32 work; and the dense bf16 tensor-core rate (no sparsity), taken
# for the batched K1's mma work
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
TENSOR_BF16_OPS_PER_S = 989e12
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
# V1, the core pass's sequential first-fit of VC: an XLA loop of the JAX
# package (no Pallas kernel), a CUDA kernel of the port
V1_SOURCE = "gardenia_tpu_torch/csrc/vc_core_firstfit.cu"
V1_REPLACES = "gardenia_tpu/solvers/vc.py:268"
V1_REPEATS = 20             # launches on one core that must all agree
# Q1, the per-vertex k-clique count in local bitmap graphs: it replaces the
# XLA expansion, mask and rotation passes of the JAX package's kCL (no
# Pallas kernel)
Q1_SOURCE = "gardenia_tpu_torch/csrc/kcl_local_count.cu"
Q1_REPLACES = "gardenia_tpu/mining/kcl.py:175"
# Q1 against its plain version at k = 5: R-MAT-14 launches the CTA shape
# (out-degrees 65..145) and the warp shape, the two runs R-MAT-16 launched
# (its widest out-degree is 254, under HUB_DEGREE); the hubs' run at k = 5
# is held by the hand cases (K_{513,513}, K_{1024,1024}, the lone hub)
KCL_K5_SCALE = 14
# E1, the f32 plus-times ELL apply: it replaces the XLA gather-reduce of
# the JAX package's spmv_ell (no Pallas kernel)
E1_SOURCE = "gardenia_tpu_torch/csrc/ell_spmv.cu"
E1_REPLACES = "gardenia_tpu/ops/spmv.py:26"
# F1, SSSP's sparse relax: it replaces the XLA `sparse` branch of the JAX
# package's bucket rounds (no Pallas kernel); timed at kron20w's shape
# (graphbench's configuration, scale 20) on the widest and the median
# sparse round of one delta-stepping solve from F1_SEED's source
F1_SOURCE = "gardenia_tpu_torch/csrc/frontier_relax.cu"
F1_REPLACES = "gardenia_tpu/solvers/sssp.py:77"
F1_SEED = 3024000007
F1_DELTA = 16               # the kron20-sssp cell's delta
TRI_CHUNK = 1 << 23         # edge_triangle_counts' step on the card, wedges
# (VC_SPARSE_CAPS, VC_CORE_CAP) that make R-MAT-16 take the tiers that no
# default R-MAT solve takes: 78 dense and 34 sparse rounds; then 36 dense,
# 3 sparse and a core pass of 468 (counted on the CPU)
VC_FORCED_TIERS = (((1 << 14, 1 << 17), 0), ((1 << 15, 1 << 19), 512))
# SymGS against its f64 references: beside the CLI's l2 < 1e-4 (a squared
# ratio, so 1% relative), a limit that an f32 sweep meets and a bf16 one
# (some 1e-5) does not; measured 1.1e-16 at R-MAT-16 and 7.8e-17 at
# R-MAT-20 on an H100 80GB HBM3 at 700 W
SYMGS_F64_L2 = 1e-10
# GS1, the sweep of one SymGS colour block: it replaces one masked slab
# SpMV of the JAX package's symgs_solver (XLA, no Pallas kernel); held to
# its plain version block by block (only a row's sum order differs) and
# timed at hpcg20's shape (graphbench's configuration, scale 20)
GS1_SOURCE = "gardenia_tpu_torch/csrc/symgs_sweep.cu"
GS1_REPLACES = "gardenia_tpu/solvers/symgs.py:78"
GS1_REL = 1e-6
GS1_SEED = 3027000017
# SGD at R-MAT-16 against its f64 replica: 4 epochs; the limits sit above
# f32 rounding (on the CPU the port's f32 epoch differs from the replica
# by 8e-8 in the trace and 6e-6 in the factors, relative to their max),
# which a card's atomics add in no fixed order
SGD_SMOKE_EPOCHS = 4
SGD_TRACE_REL = 1e-5
SGD_FACTOR_REL = 1e-4
# the JAX package's final RMSE of the same bench on the TPU
# (BENCH_SWEEP_r3.jsonl), printed beside the port's for comparison only
SGD_TPU_FINAL_RMSE = 1.28286874294281
# the JAX package's count on the bench's R-MAT-20 graph, in three rounds
# (BENCH_SWEEP_r2.jsonl:7, BENCH_SWEEP_r3.jsonl:6, BENCH_SWEEP_r5.jsonl:6)
TC_RMAT20_TRIANGLES = 424_573_866
# the diamonds of the bench's R-MAT-20 graph: the port's 4-census on an
# NVIDIA H100 80GB HBM3 at 700 W (no TPU record exists at this scale)
SGL_DIAMOND_RMAT20 = 280_503_420_577
# gSpan (fsm_solver at k = 3) on the card against CPU tensors: R-MAT-9
# with seeded random labels from an alphabet of 16 at minsup 16, where
# level 3 stays under MAX_EMBEDDINGS and finds 388 of the 507 frequent
# patterns (20 s on 4 CPU threads; on the degree labels level 3 passes
# MAX_EMBEDDINGS below minsup 250 and no edge is frequent from there)
FSM_GSPAN_SCALE, FSM_GSPAN_LABELS, FSM_GSPAN_MINSUP = 9, 16, 16


RUN_START = time.perf_counter()


def clock(phase: int) -> None:
    """Print when a phase starts, in seconds since the run began."""
    print(f"[{phase}] starts at {time.perf_counter() - RUN_START:.1f} s")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        fail(f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr}")
    return proc.stdout.strip()


# lscpu's fields that name the CPU (a virtual machine may report its model
# name as unknown and still give the family, model and stepping)
CPU_FIELDS = ("Model name", "Vendor ID", "CPU family", "Model", "Stepping",
              "BogoMIPS", "L3 cache")


def host_lines() -> list:
    """The host's CPU (lscpu's CPU_FIELDS), cores (nproc) and load
    (uptime)."""
    fields = dict(ln.split(":", 1) for ln in run(["lscpu"]).splitlines()
                  if ":" in ln)
    cpu = [f"{k}: {fields[k].strip()}" for k in CPU_FIELDS if k in fields]
    return ["; ".join(cpu) if cpu else "Model name: n/a",
            f"nproc: {run(['nproc'])}", f"uptime: {run(['uptime'])}"]


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


def bound(nbytes: float, ops: float, ops_per_s: float = VECTOR_OPS_PER_S
          ) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over their peak rate (the vector peak unless given)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / ops_per_s * 1e3
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


def dense_part(hyb, x3d, mb: int):
    """hyb's dense part as spmv_hybrid_batched computes it, (mb, 128, S)
    f32: K1 on every panel array (dense_panel_matmul_arrays), the slots
    summed into their block rows by index_add_."""
    import torch
    from gardenia_tpu_torch.ops import panel
    S = x3d.shape[-1]
    y3d = torch.zeros((mb, 128, S), dtype=torch.float32, device=x3d.device)
    parts = panel.dense_panel_matmul_arrays(
        [(p.panel, p.src) for p in hyb.dense], x3d, S)
    for p, part in zip(hyb.dense, parts):
        y3d.index_add_(0, p.rows, part)
    return y3d


def bsr_library(hyb, nbc: int, mb: int, dtype):
    """hyb's dense part as one torch.sparse_bsr_tensor with 128 x 128 blocks
    (mb x nbc blocks), values in dtype: every slot's blocks at their block
    column from src, sorted within a block row, all-zero padding blocks
    dropped, the slots of a split row merged into their block row."""
    import torch
    keys, parts = [], []
    for p in hyb.dense:
        R, W = p.src.shape
        blocks = p.panel.view(R, 128, W, 128).permute(0, 2, 1, 3)
        keep = blocks.reshape(R, W, -1).ne(0).any(dim=2)
        parts.append((blocks, keep))
        keys.append((p.rows.long()[:, None] * nbc + p.src.long())[keep])
    keys = torch.cat(keys)
    order = torch.argsort(keys)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=order.device)
    values = torch.empty((order.numel(), 128, 128), dtype=dtype,
                         device=keys.device)
    start = 0
    for blocks, keep in parts:
        k = int(keep.sum())
        values[pos[start:start + k]] = blocks[keep].to(dtype)
        start += k
    keys = keys[order]
    crow = torch.zeros(mb + 1, dtype=torch.int64, device=keys.device)
    crow[1:] = torch.bincount(keys // nbc, minlength=mb).cumsum(0)
    return torch.sparse_bsr_tensor(crow, keys % nbc, values,
                                   size=(mb * 128, nbc * 128))


def library_yardstick(hyb, x3d, mb: int, dtype, want, limit: float) -> dict:
    """K1's library yardstick: one PyTorch call, torch.sparse_bsr_tensor
    (values in dtype) @ the operand, over hyb's whole dense part, held to
    want (K1's dense part, dense_part()) within K1's limit on max|diff| /
    max|y| and timed by CUDA events; the device kernels it ran name its
    backend.  Where torch refuses the dtype or misses the limit, library_ms
    is None and library_error says why."""
    import warnings
    import torch
    S = x3d.shape[-1]
    warnings.filterwarnings("ignore", message="Sparse")   # beta notices
    try:
        A = bsr_library(hyb, x3d.shape[0], mb, dtype)
        x2d = x3d.reshape(-1, S).to(dtype)
        y = (A @ x2d).float()
        torch.cuda.synchronize()
    except Exception as e:                   # torch may refuse the dtype
        return {"library_ms": None,
                "library_error": f"{type(e).__name__}: {e}"[:400]}
    rel = float((y - want.reshape(-1, S)).abs().max()
                / max(1e-30, float(want.abs().max())))
    del y
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        A @ x2d
        torch.cuda.synchronize()

    def device_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))
    top = sorted(prof.key_averages(), key=device_us, reverse=True)
    out = {"library_backend": "; ".join(
               f"{e.key[:70]} x{e.count} {device_us(e) / 1e3:.3f} ms"
               for e in top[:4] if device_us(e) > 0) or "not captured",
           "library_rel": rel}
    ms = cuda_ms(lambda: A @ x2d, reps=3, warmup=1)
    if rel < limit:
        out["library_ms"] = ms
    else:                                    # timed, but not the same sum
        out.update(library_ms=None, library_ms_off_limit=ms, library_error=(
            f"{dtype} BSR @ operand misses K1's limit: max|diff| / max|y| "
            f"{rel:.3e} >= {limit} (its result is {dtype})"))
    return out


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


def tc_streams(data):
    """(kernel name, class label, W, rows, first index, second index) for
    every pair stream of a TCData: H1 on the hub pairs, then K3 and K4
    each on every width class."""
    out = []
    if data.bitmap is not None:
        bmp, hu, hv = data.bitmap
        out.append(("bitmap_count", "hub", None, bmp, hu, hv))
    for W, (cu, cv) in sorted(data.streams.items()):
        out += [(name, f"W{W}", W, data.table, cu, cv)
                for name in ("rot_count", "merge_count")]
    return out


def tc_call(name, rows, a, b, W, plain=False):
    """One TC kernel (or its plain version) on one pair stream."""
    from gardenia_tpu_torch.ops import tc_count as tcc
    if name == "bitmap_count":
        return (tcc.bitmap_count_plain if plain else tcc.bitmap_count)(
            rows, a, b)
    if name == "rot_count":
        return (tcc.rot_count_plain if plain else tcc.rot_count)(
            rows, a, b, W)
    return (tcc.merge_count_plain if plain else tcc.merge_count)(
        rows, a, b, W)


def stagings(rows, block: int) -> int:
    """Stagings of a kernel that stages a shared row once per run of equal
    `rows` within each block of `block` consecutive pairs."""
    import torch
    new = torch.ones(rows.shape[0], dtype=torch.bool, device=rows.device)
    new[1:] = rows[1:] != rows[:-1]
    new[::block] = True
    return int(new.sum())


def tc_read_bytes(name, rows, a, b, W) -> int:
    """Bytes of rows that a TC kernel reads for one stream, as its design
    reads them: K3 and K4 cu's W-prefix per pair and row cv per staging
    (K3 restages per lane group's part, K4 per warp's block); H1 the
    nonzero quads of bmp[hu] in bmp[hv] per pair and row hu per
    staging."""
    from gardenia_tpu_torch.ops import tc_count as tcc
    n = a.shape[0]
    blocks = tcc.kernel_blocks()
    if name in ("rot_count", "merge_count"):
        block = blocks[name.replace("count", "block")]
        return 4 * W * n + 512 * stagings(b, block)
    nzq = (rows.view(rows.shape[0], -1, 4) != 0).any(dim=2).sum(dim=1)
    return (16 * int(nzq[a.long()].sum())
            + 4 * rows.shape[1] * stagings(a, blocks["bitmap_block"]))


def tc_need_bytes(name, rows, a, b, W) -> int:
    """Bytes the inputs of one stream need, each moved once, whatever
    design reads them: the index pair and the count of every pair (12
    bytes), and the rows the stream refers to, each distinct one once: K3
    and K4 the 512-byte row of every distinct cv and the W-prefix of
    every distinct cu, at most the whole table; H1 the bitmap row of
    every distinct hub."""
    import torch
    n = a.shape[0]
    if name in ("rot_count", "merge_count"):
        need = (512 * int(torch.unique(b).numel())
                + 4 * W * int(torch.unique(a).numel()))
        return min(need, rows.numel() * 4) + 12 * n
    hubs = int(torch.unique(torch.cat([a, b])).numel())
    return 4 * rows.shape[1] * hubs + 12 * n


def tc_ops(name, rows, a, b, W) -> int:
    """Operations the inputs need, whatever implements them: K3 and K4
    one 7-step search per valid id of cu's W-prefix; H1 an AND and a
    popcount per nonzero word of the sparser row."""
    import torch
    if name in ("rot_count", "merge_count"):
        fill = (rows >= 0).sum(dim=1).clamp(max=W)
        return 7 * int(fill[a.long()].sum())
    nzw = (rows != 0).sum(dim=1)
    return 2 * int(torch.minimum(nzw[a.long()], nzw[b.long()]).sum())


def run_streams(rows: int, block: int, special, rng):
    """Small edge-case pair streams over `rows` rows, as (label, run side,
    other side) int32 arrays; the run side is the index whose row a kernel
    stages once per run of equal values in a block of `block` pairs."""
    n = 3 * block + 37                  # not a multiple of the block

    def rnd(k):
        return rng.integers(0, rows, k)
    across = rnd(n)
    lo = max(0, block - 20)
    across[lo:block + 20] = across[lo]
    sp = np.asarray(special)
    cases = [("one pair", rnd(1), rnd(1)),
             ("sorted runs", np.sort(rng.choice(rnd(7), n)), rnd(n)),
             ("a run across a block boundary", across, rnd(n)),
             ("a run longer than a block", np.full(n, rnd(1)[0]), rnd(n)),
             ("no runs", rnd(n), rnd(n)),
             ("special rows", np.sort(rng.choice(sp, n)),
              np.where(rng.random(n) < 0.5, rng.choice(sp, n), rnd(n)))]
    return [(label, r.astype(np.int32), o.astype(np.int32))
            for label, r, o in cases]


def hold_tc_streams(data, label, dev, stats, seed, phase) -> None:
    """Every TC kernel against its plain version, pair by pair and exact,
    on every stream of data (K3 and K4 on every class, H1 on the hub
    pairs), as uploaded and on a seeded random permutation of it."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    for name, cls, W, rows, a, b in tc_streams(data):
        y_p = tc_call(name, rows, a, b, W, plain=True)
        tag = f"{label} {cls}"
        tc_compare(name, tc_call(name, rows, a, b, W), y_p, tag, stats)
        perm = torch.randperm(a.shape[0], generator=gen).to(dev)
        tc_compare(name, tc_call(name, rows, a[perm].contiguous(),
                                 b[perm].contiguous(), W),
                   y_p[perm], f"{tag} shuffled", stats)
        print(f"[{phase}] {TC_KERNELS[name][0]} {label} {cls:>4}: "
              f"{a.shape[0]:8d} pairs, equal to the plain version as "
              f"uploaded and shuffled")


def hold_edge_cases(table, dev, stats) -> None:
    """K3 and K4 (every W) and H1 against their plain versions on
    small edge-case streams (run_streams): one pair, runs across and
    longer than a block, n no multiple of the block, no runs; for K3 and
    K4 all-pad rows, the sentinel row C and a full row on either side,
    and for K3 the block taken as a lane group's part, as the four parts
    a warp takes at W8, and as the 32 a CTA takes; for H1 all-zero rows
    (and the zero sentinel), an all-ones row, rows nonzero in one tile
    only, and wpad of 4 words, 768 and more than one shared tile."""
    import torch
    from gardenia_tpu_torch.ops import tc_count as tcc
    rng = np.random.default_rng(23)
    blocks = tcc.kernel_blocks()
    C = table.shape[0] - 1                   # tc_prep's all-pad sentinel
    extra = torch.full((2, 128), -1, dtype=torch.int32, device=dev)
    extra[1] = torch.arange(0, 256, 2, dtype=torch.int32, device=dev)
    t = torch.cat([table, extra])            # + an all-pad and a full row
    special = [C, C + 1, C + 2]
    rot = blocks["rot_block"]
    for name, sizes in (("rot_count", (rot, 4 * rot, 32 * rot)),
                        ("merge_count", (blocks["merge_block"],))):
        checked = 0
        for block in sizes:
            for label, run, other in run_streams(t.shape[0], block, special,
                                                 rng):
                cu = torch.from_numpy(other).to(dev)
                cv = torch.from_numpy(run).to(dev)
                for W in tcc.ROT_WIDTHS:
                    tc_compare(name, tc_call(name, t, cu, cv, W),
                               tc_call(name, t, cu, cv, W, plain=True),
                               f"edge case {label} block {block} W{W}",
                               stats)
                    checked += 1
        print(f"[5] {TC_KERNELS[name][0]} edge cases: {checked} streams (6 "
              f"cases x 5 W x blocks {sizes}) equal to the plain version")
    tile = blocks["bitmap_tile_words"]
    for wpad in (4, 768, 2 * tile + 768):
        H = 40
        words = rng.integers(0, 2 ** 32, (H, wpad), dtype=np.uint64)
        keep = rng.random((H, wpad)) < rng.random((H, 1)) * 0.4
        bmp = np.where(keep, words, 0).astype(np.uint32)
        bmp[3] = 0xFFFFFFFF                  # every sign bit set
        bmp[5:8] = 0                         # all-zero hub rows
        bmp[-1] = 0                          # the zero sentinel row
        if wpad > tile:                      # nonzero in one tile only
            bmp[8, :] = 0
            bmp[8, -5] = 0x80000001
            bmp[9, :tile] = 0
            bmp[9, 2 * tile:] = 0
        bm = torch.from_numpy(bmp.view(np.int32)).to(dev)
        for label, run, other in run_streams(
                H, blocks["bitmap_block"], [3, 5, 6, 7, 8, 9, H - 1], rng):
            hu = torch.from_numpy(run).to(dev)
            hv = torch.from_numpy(other).to(dev)
            tc_compare("bitmap_count", tcc.bitmap_count(bm, hu, hv),
                       tcc.bitmap_count_plain(bm, hu, hv),
                       f"edge case {label} wpad {wpad}", stats)
    print(f"[5] H1 edge cases: 6 cases x wpad (4, 768, {2 * tile + 768}) "
          f"equal to the plain version")


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



def turns(fns: dict, reps: dict = None, order=("plain", "kernel", "kernel",
                                               "plain")) -> tuple:
    """Mean ms of each fn by CUDA events, timed in turns (plain, kernel,
    kernel, plain) on this card; returns (means, runs)."""
    runs = {k: [] for k in fns}
    for which in order:
        runs[which].append(cuda_ms(fns[which], warmup=1,
                                   reps=(reps or {}).get(which, 3)))
    return {k: sum(v) / len(v) for k, v in runs.items()}, runs


def check_k1_batched(hyb, label: str, S_list, dev, st: dict,
                     quiet: bool = False) -> None:
    """K1 at S > 8 against its plain version on every panel array of hyb:
    a random f32 operand (limit K1_REL_LIMIT on max|diff| / max|y|), a
    random bf16 operand (K1_BF16_REL_LIMIT) and a 0/1 bf16 mask (exact).
    Counts into st; max_abs_err and max_rel_err are the f32 operand's."""
    import torch
    from gardenia_tpu_torch.ops import panel
    qx = max(int(p.src.max()) for p in hyb.dense) + 1
    rng = np.random.default_rng(9)
    for S in S_list:
        xf = torch.from_numpy(rng.random((qx, 128, S)).astype(np.float32))
        mask = torch.from_numpy(rng.random((qx, 128, S)) < 0.3)
        ops = (("f32", xf.to(dev)), ("bf16", xf.to(dev).to(torch.bfloat16)),
               ("mask", mask.to(dev).to(torch.bfloat16)))
        for p in hyb.dense:
            route = panel.kernel_route(p.panel.dtype, torch.float32, S)
            line = []
            for name, x in ops:
                y_k = panel.dense_panel_matmul(p.panel, p.src, x, S)
                y_p = panel.dense_panel_matmul_plain(p.panel, p.src, x, S)
                torch.cuda.synchronize()
                if y_k.shape != y_p.shape or y_k.dtype != torch.float32:
                    fail(f"K1 batched {label}: shape/dtype {y_k.shape} "
                         f"{y_k.dtype} vs plain {y_p.shape}")
                diff = (y_k - y_p).abs()
                err = float(diff.max())
                rel = err / max(1e-30, float(y_p.abs().max()))
                st["arrays_checked"] += 1
                if name == "mask" and p.panel.dtype != torch.float32:
                    # integer cells x 0/1: every sum is an exact integer
                    wrong = int((diff != 0).sum())
                    st["mask_elements"] += int(diff.numel())
                    st["mask_mismatches"] += wrong
                    bad = wrong != 0
                    line.append(f"mask {wrong} of {diff.numel()} differ")
                elif name == "bf16" and route == "tc":
                    st["max_rel_err_bf16"] = max(st["max_rel_err_bf16"], rel)
                    if p.width == 32:
                        st["w32_rel_bf16"] = max(st["w32_rel_bf16"], rel)
                    bad = not (np.isfinite(rel) and rel < K1_BF16_REL_LIMIT)
                    line.append(f"bf16 rel {rel:.2e}")
                else:
                    st["max_abs_err"] = max(st["max_abs_err"], err)
                    st["max_rel_err"] = max(st["max_rel_err"], rel)
                    if p.width == 32 and name == "f32":
                        st["w32_rel_f32"] = max(st["w32_rel_f32"], rel)
                    bad = not (np.isfinite(rel) and rel < K1_REL_LIMIT)
                    line.append(f"{name} rel {rel:.2e}")
                st["mismatches"] += int(bad)
                if bad:
                    fail(f"K1 at S={S} disagrees with its plain version "
                         f"({label}, {p.panel.dtype}, W={p.width}, operand "
                         f"{name}): max|diff| {err}, rel {rel}")
            if not quiet:
                print(f"  K1 {label} {str(p.panel.dtype)[6:]} W={p.width:2d} "
                      f"R={p.src.shape[0]:6d} S={S:3d} [{route}]: "
                      + ", ".join(line))


def k1_batched_edge_cases(dev, st: dict) -> None:
    """Small hand-made panel arrays: one slot of one block (R = 1, W = 1),
    a slot whose blocks are all zero beside a full one, the widest slot
    (W = 32) with one nonzero cell per block, negative cells, bf16 panels
    (integers 128..255); at S = 9, 16, 100, 128, 136 and 256."""
    import torch
    from gardenia_tpu_torch.ops import bsr
    rng = np.random.default_rng(31)

    def arr(R, W, fill, bf16=False):
        pn = np.zeros((R, 128, W * 128), np.float32 if bf16 else np.int8)
        fill(pn)
        src = rng.integers(0, 40, (R, W)).astype(np.int32)
        tp = torch.from_numpy(pn)
        return bsr.DensePanel((tp.to(torch.bfloat16) if bf16 else tp).to(dev),
                              torch.from_numpy(src).to(dev),
                              torch.arange(R, dtype=torch.int32, device=dev),
                              W)

    def sparse(pn):
        pn[:] = (rng.random(pn.shape) < 0.01) * rng.integers(-3, 4, pn.shape)

    def one_cell_a_block(pn):
        for w in range(pn.shape[2] // 128):
            pn[:, rng.integers(0, 128), w * 128 + rng.integers(0, 128)] = 1

    def zero_slot(pn):
        sparse(pn)
        pn[1] = 0

    cases = [("R=1 W=1", arr(1, 1, sparse)),
             ("an all-zero slot", arr(3, 4, zero_slot)),
             ("W=32, one cell a block", arr(2, 32, one_cell_a_block)),
             ("dense +-127", arr(2, 2, lambda pn: pn.__setitem__(
                 slice(None), rng.integers(-127, 128, pn.shape)))),
             ("bf16 panels", arr(3, 4, lambda pn: pn.__setitem__(
                 slice(None), (rng.random(pn.shape) < 0.05)
                 * rng.integers(128, 256, pn.shape)), bf16=True))]
    for label, p in cases:
        hyb = bsr.HybridMatrix((p,), None, None, None, None)
        check_k1_batched(hyb, f"edge case {label}", K1_EDGE_S, dev, st,
                         quiet=True)
    print(f"[9] K1 batched edge cases: {len(cases)} arrays x S {K1_EDGE_S} x "
          f"3 operands equal to the plain version")


def brandes_numpy(g, s: int) -> np.ndarray:
    """Brandes' dependencies from source s (source level included),
    float64, not normalized: level-synchronous numpy over the host CSR,
    independent of the port's torch code."""
    m = g.m
    src = np.repeat(np.arange(m, dtype=np.int64), np.diff(g.rowptr))
    dst = np.asarray(g.colidx, np.int64)
    depth = np.full(m, -1, np.int64)
    sigma = np.zeros(m, np.float64)
    depth[s], sigma[s] = 0, 1.0
    d = 0
    while True:
        on = depth[src] == d
        tgt = dst[on]
        depth[tgt[depth[tgt] < 0]] = d + 1
        sel = depth[tgt] == d + 1
        if not sel.any():
            break
        np.add.at(sigma, tgt[sel], sigma[src[on][sel]])
        d += 1
    delta = np.zeros(m, np.float64)
    for lvl in range(d - 1, -1, -1):
        e = (depth[src] == lvl) & (depth[dst] == lvl + 1)
        u, v = src[e], dst[e]
        np.add.at(delta, u, sigma[u] / sigma[v] * (1.0 + delta[v]))
    return delta


def normalized(scores: np.ndarray) -> np.ndarray:
    return (scores / max(scores.max(), 1e-30)).astype(np.float32)


def bfs_depths_scipy(g, sources) -> np.ndarray:
    """(m, S) int32 BFS depths from scipy's breadth_first_order on the
    host CSR: a node's depth is its predecessor's plus one, filled in
    level by level along the order."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import breadth_first_order
    from gardenia_tpu_torch.core import types as T
    a = sp.csr_matrix((np.ones(g.nnz, np.int8), g.colidx, g.rowptr),
                      shape=(g.m, g.m))
    out = np.full((g.m, len(sources)), T.MYINFINITY, np.int32)
    for j, s in enumerate(sources):
        order, pred = breadth_first_order(a, int(s), directed=True,
                                          return_predecessors=True)
        depth = out[:, j]
        depth[s] = 0
        todo = order[1:]
        while todo.size:                       # one pass per level
            ready = depth[pred[todo]] != T.MYINFINITY
            depth[todo[ready]] = depth[pred[todo[ready]]] + 1
            todo = todo[~ready]
    return out


def bfs_depths_bits(g, sources) -> np.ndarray:
    """(m, S) int32 BFS depths of all S sources at once, a level-synchronous
    numpy BFS on the host CSR (g symmetric): a bit a source in uint64
    words, each level's frontier pulled along the rows by one
    bitwise_or.reduceat over the gathered neighbour words."""
    from gardenia_tpu_torch.core import types as T
    S = len(sources)
    cols = np.arange(S)
    seen = np.zeros((g.m, -(-S // 64)), np.uint64)
    np.bitwise_or.at(seen, (np.asarray(sources), cols // 64), np.left_shift(
        np.uint64(1), (cols % 64).astype(np.uint64)))
    out = np.full((g.m, S), T.MYINFINITY, np.int32)
    rows = np.diff(g.rowptr) > 0
    starts = np.asarray(g.rowptr[:-1], np.int64)[rows]
    frontier, level = seen.copy(), 0
    while True:
        bits = np.unpackbits(frontier.view(np.uint8), axis=1,
                             bitorder="little")[:, :S].astype(bool)
        if not bits.any():
            return out
        out[bits] = level
        pulled = np.zeros_like(frontier)
        pulled[rows] = np.bitwise_or.reduceat(frontier[g.colidx], starts,
                                              axis=0)
        frontier = pulled & ~seen
        seen |= frontier
        level += 1


def scipy_csr(g, data=None):
    """g's CSR as a scipy matrix (ones, or `data` in CSR order)."""
    import scipy.sparse as sp
    vals = np.ones(g.nnz, np.float64) if data is None else data
    return sp.csr_matrix((vals, g.colidx, g.rowptr), shape=(g.m, g.n))


def spmv_phase(dev, gpu: str, g, hyb, k1_stats: dict) -> dict:
    """Phase 13: K1 in the SpMV solver's threshold-64 layouts, every SpMV
    variant against the serial product, the R-MAT-20 SpMV bench on the
    PR layout, and one apply on the hybrid layout beside ELL-only ones.
    Returns K1's launches in the bench and the timings."""
    import torch
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.core import views
    from gardenia_tpu_torch.core.generate import generate_graph
    from gardenia_tpu_torch.core.graph import Graph
    from gardenia_tpu_torch.ops import bsr, panel
    from gardenia_tpu_torch.ops.semiring import F32_PLUS_TIMES
    from gardenia_tpu_torch.ops.spmv import spmv_ell
    from gardenia_tpu_torch.solvers import spmv
    from gardenia_tpu_torch.verify import maximum_relative_error, oracles
    limit = float(np.sqrt(np.finfo(np.float32).eps))

    # K1 in every panel array of the threshold-64 layouts the solver builds
    gd = generate_graph("rmat", scale=SMOKE_SCALE, degree=16,
                        symmetrize=False, need_reverse=True)
    cases = [(f"rmat{SMOKE_SCALE} directed x 0.2", gd,
              np.full(gd.nnz, 0.2, np.float32), torch.int8)]
    for kind, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        gw = weighted_graph(kind)
        cases.append((f"weighted-{kind}", gw,
                      np.asarray(gw.weights, np.float32), dtype))
    for label, gc, Ax, dtype in cases:
        run = spmv.hybrid_layout(gc, Ax, dev)
        if not run.hyb.dense or any(p.panel.dtype != dtype
                                    for p in run.hyb.dense):
            fail(f"the threshold-64 layout of {label} must hold {dtype} "
                 f"panels")
        if (run.hyb.scale != 1.0) != (dtype == torch.int8):
            fail(f"{label}: scale {run.hyb.scale}")
        check_k1(run.hyb, f"thr64 {label}", (1,), dev, k1_stats)
        print(f"[13] threshold-64 layout of {label}: "
              f"{len(run.hyb.dense)} panel arrays of {dtype}, "
              f"{run.hyb.num_blocks} blocks, scale {run.hyb.scale}; K1 "
              f"matches its plain version")

    # every variant against the serial product (push_pb on the transpose)
    x16 = np.random.default_rng(13).random(gd.n).astype(np.float32)
    gt = Graph(gd.in_rowptr, gd.in_colidx, num_cols=gd.m)
    errs = {}
    for label, gc, Ax, _ in cases:
        xs = x16 if gc is gd else \
            np.random.default_rng(14).random(gc.n).astype(np.float32)
        want = oracles.spmv_serial(gc, Ax, xs)
        for variant in ("ell", "hybrid", "segment", "push_pb", "auto"):
            if variant == "push_pb":
                if gc is not gd:
                    continue
                # the transpose of the transpose: Ax is uniform, so the
                # values need no reordering
                y = spmv.spmv_solver(gt, np.full(gt.nnz, 0.2, np.float32),
                                     xs, variant=variant, device=dev)
            else:
                y = spmv.spmv_solver(gc, Ax, xs, variant=variant,
                                     device=dev)
            y = y.cpu().numpy()
            if y.shape != (gc.m,) or not np.isfinite(y).all():
                fail(f"spmv {variant} {label}: not finite of shape (m,)")
            errs[f"{variant} {label}"] = maximum_relative_error(y, want)
    print(f"[13] SpMV variants vs the serial product (max rel err, limit "
          f"sqrt(eps) {limit:.3e}): " + json.dumps(errs))
    if not all(e < limit for e in errs.values()):
        fail("an SpMV variant disagrees with the serial product")

    # the main path: the SpMV bench at R-MAT-20 on the PR layout
    solves = bench.WARMUP + bench.ITERS
    n_before = len(g._device_cache)
    panel.LAUNCHES.update(simt=0, tc=0)
    record, _, y = bench.bench_spmv(MAIN_SCALE, dev, g=g)
    launches = dict(panel.LAUNCHES)
    print(json.dumps(record))
    g2, hyb_b, _ = views.relabeled_hybrid(g, dev)
    want = record["detail"]["reps"] * len(hyb.dense) * solves
    print(f"[13] spmv bench rmat{MAIN_SCALE}: K1 launches {launches} over "
          f"{solves} solves ({want} = reps x panel arrays x solves); the "
          f"layout is phase 4's: {hyb_b is hyb}; cache entries of the "
          f"graph before/after {n_before}/{len(g._device_cache)}")
    if hyb_b is not hyb or launches != {"simt": want, "tc": 0} or want == 0:
        fail("the SpMV bench did not run K1 reps x arrays x solves times "
             "on phase 4's layout")
    # the power loop in scipy over the relabelled CSR, in f64
    a2 = scipy_csr(g2) * 0.2
    xr = np.full(g2.n, 0.3)
    for _ in range(record["detail"]["reps"]):
        yr = a2 @ xr
        xr = yr / np.abs(yr).max()
    err = float(np.abs(y.cpu().numpy() - xr).max())
    print(f"[13] the bench's 8-apply power loop vs scipy's (f64): max|diff|"
          f" {err:.3e} (max|y| = 1)")
    if not err < 1e-5:
        fail(f"the SpMV bench's power loop disagrees with scipy's: {err}")

    # one apply: the hybrid layout (K1 + ELL remainder) beside ELL-only
    # ones (the generator's ids; the relabelled ids that PR's "ell" sweeps)
    x = torch.from_numpy(np.random.default_rng(15).random(g.n)
                         .astype(np.float32)).to(dev)
    ell_orig = views.ell(g, dev, reverse=True)
    ell_rel = views.ell(g2, dev, reverse=True)
    y_h = bsr.spmv_hybrid(hyb, x, num_rows=g.m)
    for name, mat in (("ell", ell_orig), ("ell relabelled", ell_rel)):
        y_e = spmv_ell(mat, x, semiring=F32_PLUS_TIMES, num_rows=g.m)
        if name == "ell relabelled":
            rel = float((y_h - y_e).abs().max() / y_e.abs().max())
            if not rel < 1e-5:
                fail(f"the hybrid apply disagrees with the ELL one: {rel}")
    applies = {"hybrid": lambda: bsr.spmv_hybrid(hyb, x, num_rows=g.m)}
    for name, mat in (("ell", ell_orig), ("ell relabelled", ell_rel)):
        applies[name] = functools.partial(spmv_ell, mat, x,
                                          semiring=F32_PLUS_TIMES,
                                          num_rows=g.m)
    ms, busy = {}, {}
    for which in list(applies) * 2:
        ms.setdefault(which, []).append(cuda_ms(applies[which], reps=10))
    # the device's own time: busy ms an apply from the profiler's kernels
    # (the events above also hold the host's enqueue where it is slower),
    # read from the trace's own device records, which hold the kernels
    # launched through the library (K1, E1) too
    from torch.profiler import ProfilerActivity, profile
    for which, fn in applies.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA
                   and e.duration_ns() > 0]
        busy[which] = {"ms": sum(e.duration_ns() for e in kernels) / 1e6 / 3,
                       "device_events": len(kernels) / 3}
    print(f"[13] gpu: {gpu}")
    print(f"[13] one PR-layout apply at rmat{MAIN_SCALE}, ms (CUDA events, "
          f"two turns): " + json.dumps(ms) + "; device busy ms an apply "
          f"(torch.profiler): " + json.dumps(busy))
    return {"launches": launches["simt"], "apply_ms": ms, "busy_ms": busy}


def sssp_phase(dev, gpu: str) -> dict:
    """Phase 14: the four SSSP variants at R-MAT-16 against the serial
    Dijkstra, with F1's launches; the grid-1024 bench against scipy's
    Dijkstra; F1 at kron20w's shape (f1_timing).  Returns F1's entry of
    the kernels line."""
    import scipy.sparse.csgraph as csg
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.core.generate import generate_graph
    from gardenia_tpu_torch.ops import relax
    from gardenia_tpu_torch.solvers.sssp import sssp_solver
    from gardenia_tpu_torch.utils import profiler
    from gardenia_tpu_torch.verify import oracles
    gw = generate_graph("rmat", scale=SMOKE_SCALE, degree=16,
                        symmetrize=True, need_reverse=True, weighted=True)
    src = int(np.argmax(gw.degrees))
    t0 = time.perf_counter()
    want = oracles.sssp_serial(gw, src)
    t_or = time.perf_counter() - t0
    f1_paths = {}
    for variant in ("bf", "delta", "hybrid", "nearfar"):
        profiler.take()
        before = relax.LAUNCHES
        t0 = time.perf_counter()
        with profiler.recording():
            res = sssp_solver(gw, src, SSSP_SMOKE_DELTA, variant=variant,
                              device=dev)
        secs = time.perf_counter() - t0
        sparse = profiler.take()["counters"].get("sssp.rounds_sparse", 0)
        f1 = relax.LAUNCHES - before
        same = bool((res.dist.cpu().numpy() == want).all())
        print(f"[14] sssp {variant} rmat{SMOKE_SCALE} weighted from {src}, "
              f"delta {SSSP_SMOKE_DELTA}: {res.iterations} rounds in "
              f"{secs:.2f} s (first solve), distances "
              f"{'equal' if same else 'NOT equal'} to the serial Dijkstra "
              f"({t_or:.1f} s); F1 launches {f1}, sparse rounds {sparse}")
        if not same or res.dist.dtype.itemsize != 4:
            fail(f"sssp {variant} disagrees with the serial Dijkstra")
        if f1 != sparse or (variant != "nearfar") != (f1 > 0):
            fail(f"sssp {variant}: {f1} F1 launches for {sparse} sparse "
                 f"rounds")
        if f1:
            f1_paths[f"sssp {variant} rmat{SMOKE_SCALE}"] = f1
    record, gg, res = bench.bench_sssp(MAIN_SCALE, dev)
    print(json.dumps(record))
    t0 = time.perf_counter()
    want = csg.dijkstra(scipy_csr(gg, np.asarray(gg.weights, np.float32)
                                  .astype(np.int32).astype(np.float64)),
                        directed=True, indices=0)
    dist = res.dist.cpu().numpy()
    same = bool(np.isfinite(want).all() and (dist == want).all())
    print(f"[14] sssp nearfar grid{1 << (MAIN_SCALE // 2)}: |V| {gg.m} |E| "
          f"{gg.nnz}, {res.iterations} rounds, distances "
          f"{'equal' if same else 'NOT equal'} to scipy's Dijkstra "
          f"({time.perf_counter() - t0:.1f} s); gpu: {gpu}")
    if not same:
        fail("the SSSP bench disagrees with scipy's Dijkstra")
    return f1_timing(dev, gpu, f1_paths)


def f1_bytes(m: int, n_active: int, scout: int) -> int:
    """What F1's round must move at least: the mask (1 B a vertex), deg
    and dist read and new written (12 B a vertex), rowptr's start of each
    active vertex (8 B), and each edge slot's column id and weight
    (8 B)."""
    return 13 * m + 8 * n_active + 8 * scout


def f1_timing(dev, gpu: str, paths: dict) -> dict:
    """F1 on kron20w (graphbench's configuration, scale 20): one
    delta-stepping solve from a seeded source of non-zero degree with
    every sparse round's inputs kept; F1 held to its plain version on
    each, exactly; then F1 and the plain version timed on the widest and
    the median round by CUDA events, beside f1_bytes over the card's
    bandwidth.  The kernels line's entry."""
    import torch
    from graphbench import generators, manifest, run as gb_run
    from gardenia_tpu_torch.ops import relax
    from gardenia_tpu_torch.solvers import sssp as ssssp
    cfg = manifest.config(manifest.load_benchmark(), "kron20w")
    t0 = time.perf_counter()
    g = gb_run.build_graph(generators.generate(cfg, F1_SEED, dev), cfg)
    deg = np.asarray(g.degrees)
    src = int(np.random.default_rng(F1_SEED).choice(np.flatnonzero(deg)))
    rounds = []
    sparse = ssssp.Relaxer.sparse

    def keep(self, dist, active, n_active, scout):
        rounds.append((dist.clone(), active.clone(), n_active, scout))
        return sparse(self, dist, active, n_active, scout)
    ssssp.Relaxer.sparse = keep
    try:
        before = relax.LAUNCHES
        res = ssssp.sssp_solver(g, src, F1_DELTA, device=dev)
        solve_f1 = relax.LAUNCHES - before
    finally:
        ssssp.Relaxer.sparse = sparse
    r = ssssp.Relaxer.of(g, dev)
    csr = (r.rowptr, r.colidx, r.wi, r.deg)
    print(f"[14] F1 on kron20w (seed {F1_SEED}): |V| {g.m} |E| {g.nnz}, "
          f"from {src}: {res.iterations} rounds, {len(rounds)} sparse "
          f"(F1 launches {solve_f1}), threshold {g.nnz // ssssp.ALPHA} "
          f"edges ({time.perf_counter() - t0:.1f} s with the build)")
    if solve_f1 != len(rounds) or not rounds:
        fail(f"F1 launched {solve_f1} times for {len(rounds)} sparse rounds")
    for i, (dist, active, n_active, scout) in enumerate(rounds):
        got = relax.sparse_relax(dist, active, n_active, scout, *csr)
        want = relax.sparse_relax_plain(dist, active, n_active, scout, *csr)
        if not torch.equal(got, want):
            fail(f"F1 differs from its plain version in sparse round {i} "
                 f"(scout {scout}): {int((got != want).sum())} vertices")
    by_scout = sorted(range(len(rounds)), key=lambda i: rounds[i][3])
    shapes = {"widest": by_scout[-1], "median": by_scout[len(rounds) // 2]}
    timed = {}
    for label, i in shapes.items():
        dist, active, n_active, scout = rounds[i]
        args = (dist, active, n_active, scout, *csr)
        ms, _ = turns({"kernel": lambda: relax.sparse_relax(*args),
                       "plain": lambda: relax.sparse_relax_plain(*args)},
                      reps={"kernel": 50, "plain": 10})
        nbytes = f1_bytes(g.m, n_active, scout)
        timed[label] = {"n_active": n_active, "scout": scout,
                        "ms": ms["kernel"], "plain_ms": ms["plain"],
                        "bytes": nbytes,
                        "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S}
        print(f"[14] F1 {label} sparse round: {n_active} active, {scout} "
              f"edges: F1 {ms['kernel']:.4f} ms, plain "
              f"{ms['plain']:.4f} ms, bound {timed[label]['bound_ms']:.4f}"
              f" ms ({nbytes} B); gpu: {gpu}")
    paths[f"sssp delta kron{MAIN_SCALE}w"] = solve_f1
    wide = timed["widest"]
    return {"name": "frontier_relax", "route": "cuda", "source": F1_SOURCE,
            "replaces": F1_REPLACES, "launches": sum(paths.values()),
            "launches_by_path": paths, "kernels_a_launch": 3,
            "sparse_rounds_held": len(rounds), "mismatches": 0,
            "max_abs_err": 0, "ms": wide["ms"], "plain_ms": wide["plain_ms"],
            "bound_ms": wide["bound_ms"], "bound_by": "bytes",
            "n_active": wide["n_active"], "scout": wide["scout"],
            **{f"{k}_median_round": v for k, v in timed["median"].items()},
            "library_ms": None}


def mst_scc_phase(dev, gpu: str, g) -> None:
    """Phase 15: the R-MAT-20 MST bench against scipy's spanning tree; the
    directed R-MAT-20 SCC bench ('color') and 'wcc' against scipy's strong
    components; cluster_threshold and random_walks at R-MAT-16."""
    import scipy.sparse.csgraph as csg
    import torch
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.cli import same_components
    from gardenia_tpu_torch.core.generate import generate_graph
    from gardenia_tpu_torch.solvers.clustering import cluster_threshold
    from gardenia_tpu_torch.solvers.sampling import random_walks
    from gardenia_tpu_torch.solvers.scc import scc_solver
    record, gw, res = bench.bench_mst(MAIN_SCALE, dev, g=g)
    print(json.dumps(record))
    t0 = time.perf_counter()
    want = float(csg.minimum_spanning_tree(
        scipy_csr(gw, np.asarray(gw.weights, np.float64))).sum())
    ok = res.total_weight == want and \
        res.edge_mask.shape == (gw.nnz,) and res.comp.shape == (gw.m,)
    print(f"[15] mst rmat{MAIN_SCALE}: weight {res.total_weight}, scipy's "
          f"minimum_spanning_tree {want} ({time.perf_counter() - t0:.1f} s):"
          f" {'equal' if ok else 'NOT equal'}")
    if not ok:
        fail("the MST bench's weight differs from scipy's")
    del gw, res
    record, gd, res = bench.bench_scc(MAIN_SCALE, dev)
    print(json.dumps(record))
    t0 = time.perf_counter()
    _, want = csg.connected_components(scipy_csr(gd), directed=True,
                                       connection="strong")
    t_sp = time.perf_counter() - t0
    for variant, r in (("color", res),
                       ("wcc", scc_solver(gd, variant="wcc", device=dev))):
        root = r.scc_root.cpu().numpy()
        ok = root.shape == (gd.m,) and same_components(root, want)
        print(f"[15] scc {variant} rmat{MAIN_SCALE}d: {r.iterations} rounds, "
              f"{len(np.unique(root))} SCCs, scipy's strong components "
              f"{want.max() + 1} ({t_sp:.1f} s): "
              f"{'a bijection' if ok else 'NOT a bijection'}")
        if not ok:
            fail(f"scc {variant} disagrees with scipy's strong components")
    del gd, res
    for weighted, thr in ((False, 0.0), (True, 128.0)):
        gc = generate_graph("rmat", scale=SMOKE_SCALE, degree=16,
                            symmetrize=True, weighted=weighted)
        res = cluster_threshold(gc, thr, device=dev)
        keep = np.ones(gc.nnz, bool) if gc.weights is None else \
            np.asarray(gc.weights, np.float32) >= np.float32(thr)
        kept = scipy_csr(gc, keep.astype(np.float64))
        kept.eliminate_zeros()          # csgraph takes stored zeros as edges
        _, want = csg.connected_components(kept, directed=False)
        labels = res.labels.cpu().numpy()
        ok = same_components(labels, want) and \
            res.num_clusters == want.max() + 1
        print(f"[15] cluster_threshold rmat{SMOKE_SCALE} threshold {thr}"
              f"{' (weighted)' if weighted else ''}: {res.num_clusters} "
              f"clusters, scipy's components {want.max() + 1}: "
              f"{'equal' if ok else 'NOT equal'}")
        if not ok:
            fail("cluster_threshold disagrees with scipy's components")
    gd16 = generate_graph("rmat", scale=SMOKE_SCALE, degree=16,
                          symmetrize=False)
    starts = np.arange(0, gd16.m, 61)
    walks = random_walks(gd16, starts, 16, seed=5, device=dev)
    again = random_walks(gd16, starts, 16, seed=5, device=dev)
    w = walks.cpu().numpy().astype(np.int64)
    a, b = w[:, :-1].ravel(), w[:, 1:].ravel()
    src = np.repeat(np.arange(gd16.m, dtype=np.int64), np.diff(gd16.rowptr))
    keys = src * gd16.m + gd16.colidx
    sink = np.diff(gd16.rowptr)[a] == 0
    ok = (walks.shape == (len(starts), 17) and (w[:, 0] == starts).all()
          and bool(torch.equal(walks, again))
          and (np.isin(a * gd16.m + b, keys) | (sink & (a == b))).all())
    print(f"[15] random_walks rmat{SMOKE_SCALE}d: {len(starts)} walkers x 16 "
          f"steps, {int(sink.sum())} steps at sinks, every step an out-edge "
          f"or a sink staying put, the seed repeating the walks: "
          f"{'yes' if ok else 'NO'}; gpu: {gpu}")
    if not ok:
        fail("random_walks left the graph or its seed")


def timed_once(fn):
    """(fn(), device ms of that one call by CUDA events)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def v1_bytes(forb, rowptr, col) -> int:
    """What V1's inputs and output need: the forbidden table, the CSR and
    chosen, each once."""
    K = forb.shape[0]
    return forb.numel() + 8 * rowptr.numel() + 4 * col.numel() + 4 * K


def v1_chain(D: int, C: int, dev):
    """(forb, rowptr, col) of a chain of D positions, each the neighbour
    of the one before, with free rows: V1's D hand-overs and nothing
    else (its colours alternate 0, 1)."""
    import torch
    rowptr = torch.zeros(D + 1, dtype=torch.int64)
    rowptr[2:] = torch.arange(1, D)
    return (torch.zeros((D, C), dtype=torch.int8, device=dev),
            rowptr.to(dev), torch.arange(D - 1, dtype=torch.int32).to(dev))


def v1_hand_cases(dev):
    """(label, forb, rowptr, col) edge cases of V1, on dev."""
    import torch
    from gardenia_tpu_torch.ops.vc_core import core_csr
    rng = np.random.default_rng(16)

    def case(label, forb, adj=None):
        K = forb.shape[0]
        i, j = (np.nonzero(adj) if adj is not None
                else (np.zeros(0, np.int64),) * 2)
        rowptr, col = core_csr(torch.from_numpy(np.asarray(i, np.int64)),
                               torch.from_numpy(np.asarray(j, np.int64)), K)
        return (label, torch.from_numpy(forb.astype(np.int8)).to(dev),
                rowptr.to(dev), col.to(dev))

    def clique(K):
        return ~np.eye(K, dtype=bool)

    def rand_adj(K, p):
        a = np.triu(rng.random((K, K)) < p, 1)
        return a | a.T

    sat = np.zeros((3, 4), np.int8)
    sat[0] = 1                                  # row 0: no free colour
    sat[1, [0, 1, 3]] = 1
    rand_forb = (rng.random((4096, 128)) < 0.5).astype(np.int8)
    rand_forb[::97] = 1                         # saturated rows
    late = np.zeros((40, 64), np.int8)
    late[:, :33] = 1                    # first zeros past the pulled ones
    return [
        case("K=1", np.zeros((1, 128))),
        case("a saturated row, C=4", sat, clique(3)),
        case("empty adjacency, K=4096 C=128", rand_forb),
        case("clique K=300 C=512", np.zeros((300, 512)), clique(300)),
        case("clique K=300 C=128 (rows 128 on saturate)",
             np.zeros((300, 128)), clique(300)),
        case("clique K=40 C=64, columns 0-32 forbidden (first zero in "
             "word 1)", late, clique(40)),
        case("random K=500 C=20 (byte search)",
             (rng.random((500, 20)) < 0.3), rand_adj(500, 0.05)),
        case("random K=2000 C=16384", (rng.random((2000, 16384)) < 0.999),
             rand_adj(2000, 0.01)),
        # no multiple of the grid's warps (SMs x 4) or a block's (4)
        case("random K=5287 C=128 (K no multiple of the warps)",
             (rng.random((5287, 128)) < 0.1), rand_adj(5287, 0.004)),
        ("chain K=3000 C=128", *v1_chain(3000, 128, dev)),
    ]


def vc_phase(dev, gpu: str, g):
    """Phase 16: V1 against its plain version (hand-made cases, the
    R-MAT-16 and R-MAT-20 cores as the solver builds them), vc_solver at
    R-MAT-16 and R-MAT-20 against vc_check and, at R-MAT-16, against the
    whole solve with the plain core loop; the R-MAT-20 VC bench.  Returns
    (V1's entry of the kernels line, the R-MAT-16 graph)."""
    import torch
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.core.generate import generate_graph
    from gardenia_tpu_torch.core.graph import from_csr_of
    from gardenia_tpu_torch.ops import vc_core
    from gardenia_tpu_torch.solvers import vc
    from gardenia_tpu_torch.verify import oracles
    stats = {"cases": 0, "mismatches": 0, "max_abs_err": 0}

    def hold(label, forb, rowptr, col):
        """V1 and the plain loop on the same inputs, exact; (chosen, the
        plain loop's ms)."""
        got = vc_core.vc_core_firstfit(forb, rowptr, col)
        want, plain_ms = timed_once(
            lambda: vc_core.vc_core_firstfit_plain(forb, rowptr, col))
        bad = int((got != want).sum())
        err = int((got - want).abs().max()) if got.numel() else 0
        stats["cases"] += 1
        stats["mismatches"] += bad
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        print(f"[16] V1 {label}: K {forb.shape[0]} C {forb.shape[1]}, "
              f"{col.numel()} lower edges, {int((got < 0).sum())} saturated"
              f", {bad} entries differ from the plain loop's")
        if bad:
            fail(f"V1 disagrees with its plain version on {label}")
        return got, plain_ms

    for label, forb, rowptr, col in v1_hand_cases(dev):
        got, _ = hold(label, forb, rowptr, col)
        if label.startswith("clique K=300"):
            K, C = forb.shape
            want = torch.arange(K, dtype=torch.int32, device=dev)
            if not torch.equal(got, torch.where(want < C, want, -1)):
                fail(f"V1 on {label} is not 0, 1, ... then saturated")
        if label.startswith("chain") and not torch.equal(
                got.cpu(), torch.arange(forb.shape[0], dtype=torch.int32) % 2):
            fail(f"V1 on {label} is not 0, 1, 0, 1, ...")

    def capturing(run, seen, first=False):
        """run() with the inputs of its V1 calls kept in `seen`: the first
        call's, or else the last's (the wrapper does not modify them)."""
        real = vc_core.vc_core_firstfit

        def spy(forb, rowptr, col):
            if not (first and seen):
                seen[:] = [(forb, rowptr, col)]
            return real(forb, rowptr, col)
        vc_core.vc_core_firstfit = spy
        try:
            return run()
        finally:
            vc_core.vc_core_firstfit = real

    def solve_capturing(graph):
        """vc_solver(graph) and the inputs of its first core pass."""
        seen = []
        t0 = time.perf_counter()
        res = capturing(lambda: vc.vc_solver(graph, device=dev), seen,
                        first=True)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ok = oracles.vc_check(graph, res.colors.cpu().numpy())
        print(f"[16] vc rmat{int(np.log2(graph.m))}: {res.num_colors} colours,"
              f" {res.iterations} rounds {json.dumps(res.rounds)}, palette "
              f"{res.palette}, first core pass {res.core_size} vertices, "
              f"first solve {secs:.2f} s; vc_check {'passes' if ok else 'FAILS'}")
        if not ok or res.colors.shape != (graph.m,) or not seen:
            fail(f"vc_solver on rmat{int(np.log2(graph.m))}: not a proper "
                 "colouring, or no core pass")
        return res, seen[0]

    g16 = generate_graph("rmat", scale=SMOKE_SCALE, degree=16,
                         symmetrize=True)
    res16, core16 = solve_capturing(g16)
    _, plain16 = hold(f"rmat{SMOKE_SCALE} core", *core16)
    # the whole solve with the plain core loop in place of V1
    real = vc_core.vc_core_firstfit
    vc_core.vc_core_firstfit = vc_core.vc_core_firstfit_plain
    try:
        res16p = vc.vc_solver(from_csr_of(g16), device=dev)
    finally:
        vc_core.vc_core_firstfit = real
    same = (torch.equal(res16.colors, res16p.colors)
            and res16.iterations == res16p.iterations)
    print(f"[16] vc rmat{SMOKE_SCALE} with the plain core loop in place of "
          f"V1: colours and rounds {'equal' if same else 'NOT equal'}")
    if not same:
        fail("vc_solver with V1 and with the plain core loop differ")
    # the dense and sparse rounds on the card against the same solve on the
    # CPU, whose plain versions the tests hold to the JAX solver
    saved = vc.VC_SPARSE_CAPS, vc.VC_CORE_CAP
    try:
        for caps, core in VC_FORCED_TIERS:
            vc.VC_SPARSE_CAPS, vc.VC_CORE_CAP = caps, core
            on_card = vc.vc_solver(from_csr_of(g16), device=dev)
            on_cpu = vc.vc_solver(from_csr_of(g16), device="cpu")
            same = (torch.equal(on_card.colors.cpu(), on_cpu.colors)
                    and on_card.rounds == on_cpu.rounds)
            print(f"[16] vc rmat{SMOKE_SCALE}, VC_SPARSE_CAPS {caps}, "
                  f"VC_CORE_CAP {core}: rounds {json.dumps(on_card.rounds)},"
                  f" {on_card.num_colors} colours; colours and rounds "
                  f"{'equal' if same else 'NOT equal'} to the CPU solve's")
            if not same:
                fail("vc_solver's dense or sparse rounds differ on the card")
    finally:
        vc.VC_SPARSE_CAPS, vc.VC_CORE_CAP = saved

    # the graph's first solve: its first core pass saturates rows at C 128
    # and the palette doubles, a case that the bench's solves, at the
    # palette the graph then remembers, no longer take
    _, first20 = solve_capturing(g)
    hold(f"rmat{MAIN_SCALE} first core pass of a fresh solve", *first20)
    del first20

    # the main path: the bench's VC, V1's launches counted around it and
    # the inputs of its last solve's core pass kept (some 50 MB, alive
    # from one solve's core pass into the next solve)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()     # earlier phases' layouts
    seen = []
    vc_core.LAUNCHES = 0
    record, _, res = capturing(
        lambda: bench.bench_vc(MAIN_SCALE, dev, g=g), seen)
    launches = vc_core.LAUNCHES
    peak = (torch.cuda.max_memory_allocated() - resident) / 2 ** 30
    print(json.dumps(record))
    solves = bench.WARMUP + bench.ITERS
    # what a dense round holds at once beside the graph's resident CSR and
    # COO: its (m, C) int32 table and mask, three int64 edge temporaries
    reckoned = (5 * g.m * res.palette + 24 * g.nnz) / 2 ** 30
    print(f"[16] vc bench rmat{MAIN_SCALE}: V1 launches {launches} over "
          f"{solves} solves ({res.rounds['core']} core passes a solve), peak "
          f"device memory {peak:.2f} GiB above the {resident / 2 ** 30:.2f} "
          f"GiB resident before (reckoned {reckoned:.2f} GiB: the "
          f"dense round's (m, {res.palette}) int32 table and mask 5 m C, "
          f"three int64 edge temporaries 24 |E|)")
    if launches == 0 or launches != solves * res.rounds["core"]:
        fail(f"V1 launches {launches} != {solves} x {res.rounds['core']}")
    if not oracles.vc_check(g, res.colors.cpu().numpy()):
        fail("the VC bench's colouring is not proper")
    # V1 held and timed on the core pass that the bench's last solve built
    if not seen or seen[0][0].shape[1] != res.palette:
        fail(f"no core pass of the VC bench at its palette {res.palette} "
             "was captured")
    core20 = seen[0]
    want20, plain20 = hold(f"rmat{MAIN_SCALE} core of the bench's last "
                           "solve", *core20)
    # a race would show as a launch that differs
    differ = sum(not torch.equal(vc_core.vc_core_firstfit(*core20), want20)
                 for _ in range(V1_REPEATS))
    print(f"[16] V1 on the bench's core, {V1_REPEATS} more launches: "
          f"{differ} differ from the plain loop's")
    if differ:
        fail(f"V1 gave another colouring in {differ} of {V1_REPEATS} "
             "launches on the same core")
    cores = {"rmat16": core16, "rmat20": core20}
    ms = {label: cuda_ms(lambda: vc_core.vc_core_firstfit(*inputs), reps=5)
          for label, inputs in cores.items()}
    depth = {label: vc_core.core_depth(inputs[1], inputs[2])
             for label, inputs in cores.items()}
    # V1 on a chain of the core's D positions: D hand-overs and no more
    floor = {label: cuda_ms(functools.partial(
        vc_core.vc_core_firstfit, *v1_chain(depth[label], inputs[0].shape[1],
                                            dev)), reps=5)
        for label, inputs in cores.items()}
    bounds = {label: bound(v1_bytes(*inputs), 0)
              for label, inputs in cores.items()}
    print(f"[16] gpu: {gpu}")
    for label, inputs in cores.items():
        K, C = inputs[0].shape
        plain = plain16 if label == "rmat16" else plain20
        print(f"[16] V1 at the {label} core (K {K}, C {C}, "
              f"{inputs[2].numel()} lower edges, depth {depth[label]}): "
              f"{ms[label]:.3f} ms ({1e3 * ms[label] / depth[label]:.3f} us a "
              f"level), plain loop {plain:.1f} ms, bound "
              f"{bounds[label][0]:.4f} ms ({bounds[label][1]}), a chain of "
              f"{depth[label]} positions {floor[label]:.3f} ms")
    entry = {
        "name": "vc_core_firstfit", "route": "cuda", "source": V1_SOURCE,
        "replaces": V1_REPLACES, "launches": launches,
        "launches_by_path": {f"vc bench rmat{MAIN_SCALE}": launches},
        **stats, "repeats_differing": differ,
        "ms": ms["rmat20"], "plain_ms": plain20,
        "bound_ms": bounds["rmat20"][0], "bound_by": bounds["rmat20"][1],
        "depth": depth["rmat20"], "depth_floor_ms": floor["rmat20"],
        "us_per_level": 1e3 * ms["rmat20"] / depth["rmat20"],
        "core_K": core20[0].shape[0], "core_C": core20[0].shape[1],
        "ms_rmat16": ms["rmat16"], "plain_ms_rmat16": plain16,
        "bound_ms_rmat16": bounds["rmat16"][0],
        "depth_rmat16": depth["rmat16"],
        "depth_floor_ms_rmat16": floor["rmat16"],
        "us_per_level_rmat16": 1e3 * ms["rmat16"] / depth["rmat16"],
        "core_C_rmat16": core16[0].shape[1], "library_ms": None}
    return entry, g16


def symgs_reference(g, Ax, x0, b, diag, colors) -> np.ndarray:
    """An independent float64 symmetric sweep: scipy's CSR with its rows
    sorted by colour, each block's row slice times x."""
    A = scipy_csr(g, np.asarray(Ax, np.float64))
    order = np.argsort(colors, kind="stable")
    P = A[order]
    ends = np.cumsum(np.bincount(colors))
    blocks = [(e - c, e) for c, e in zip(np.bincount(colors), ends) if c]
    x = np.asarray(x0, np.float64).copy()
    b, diag = np.asarray(b, np.float64), np.asarray(diag, np.float64)
    for r0, r1 in blocks + blocks[::-1]:
        rows = order[r0:r1]
        d = diag[rows]
        new = (b[rows] - P[r0:r1] @ x) / np.where(d != 0, d, 1)
        x[rows] = np.where(d != 0, new, x[rows])
    return x


def gs1_solve(label: str, solves: int, blocks: int, fn):
    """fn() (`solves` calls of symgs_solver on the card) with GS1's
    launch counter set to 0 first: fail unless it launched GS1 once a
    colour block of each half, solves x 2 x `blocks` (the non-empty
    colours); (fn's result, the launches)."""
    from gardenia_tpu_torch.ops import symgs_sweep as sw
    sw.LAUNCHES = 0
    out = fn()
    want = solves * 2 * blocks
    print(f"[17] GS1 through symgs_solver, {label}: {sw.LAUNCHES} launches "
          f"({solves} solves x 2 x {blocks} colour blocks: {want})")
    if sw.LAUNCHES != want:
        fail(f"symgs {label}: {sw.LAUNCHES} GS1 launches, not one a colour "
             f"block of each half ({want}): a block left GS1's route")
    return out, sw.LAUNCHES


def gs1_timing(dev, gpu: str) -> dict:
    """GS1 on hpcg20 (graphbench's configuration, scale 20: HPCG's
    27-point matrix, diagonal 26, -1 off it, b its row sums, x0 uniform):
    the port's colouring and colour-ordered system; GS1 held to its plain
    version block by block through one application (GS1_REL relative to
    the block's largest |x|); symgs_solver on the same inputs, which has
    to launch GS1 once a block (gs1_solve) and give the plain route's x
    within GS1_REL; then one application's 2 x colours blocks timed by
    CUDA events through GS1's C entry alone (the kernel), through
    sweep_block (the wrapper the solver calls), through the plain sweep,
    and through its torch.segment_reduce calls alone (the library call the
    port no longer makes on the card), beside the bytes an application
    needs over the card's bandwidth.  The kernels line's entry, its
    launches those of the solve."""
    import torch
    from graphbench import generators, manifest, run as gb_run
    from gardenia_tpu_torch.ops import _build, symgs_sweep as sw
    from gardenia_tpu_torch.solvers import symgs as ssymgs
    from gardenia_tpu_torch.solvers.vc import vc_solver
    cfg = manifest.config(manifest.load_benchmark(), "hpcg20")
    t0 = time.perf_counter()
    g = gb_run.build_graph(generators.generate(cfg, GS1_SEED, dev), cfg)
    deg = np.asarray(g.degrees)
    Ax = np.full(g.nnz, -1.0, np.float32)
    diag = np.full(g.m, 26.0, np.float32)
    b = (26.0 - deg).astype(np.float32)
    colors = vc_solver(g, device=dev).colors.cpu().numpy()
    sys_ = ssymgs.color_ordered(g, Ax, b, diag, colors, dev)
    args = (sys_.col, sys_.val, sys_.b, sys_.diag, sys_.update)
    blocks = sys_.blocks + sys_.blocks[::-1]
    x0 = torch.rand(g.m, generator=torch.Generator().manual_seed(
        GS1_SEED)).numpy()
    x0o = torch.from_numpy(x0).to(dev)[sys_.order]
    rows = [blk[1] - blk[0] for blk in sys_.blocks]
    print(f"[17] GS1 on hpcg20 (seed {GS1_SEED}): |V| {g.m} |E| {g.nnz}, "
          f"{len(sys_.blocks)} colours, rows a block {min(rows)}..."
          f"{max(rows)}, widest row {max(blk[5] for blk in blocks)} "
          f"({time.perf_counter() - t0:.1f} s with the build)")
    x, worst = x0o.clone(), 0.0
    for blk in blocks:
        r0, r1 = blk[:2]
        want, got = x.clone(), x.clone()
        sw.sweep_block_plain(*args, want, blk)
        sw.sweep_block(*args, got, blk)
        rel = float((got - want).abs().max()
                    / want[r0:r1].abs().max().clamp_min(1e-30))
        worst = max(worst, rel)
        x = want
    plain_x = torch.empty_like(x)
    plain_x[sys_.order] = x
    res, launches = gs1_solve(
        "hpcg20", 1, len(sys_.blocks),
        lambda: ssymgs.symgs_solver(g, Ax, x0, b, diag, colors, device=dev))
    solve_rel = float((res.x - plain_x).abs().max()
                      / plain_x.abs().max().clamp_min(1e-30))
    print(f"[17] GS1 block by block: worst block rel {worst:.3e}; the solve "
          f"against the plain route's x: rel {solve_rel:.3e} (limit "
          f"{GS1_REL})")
    if not (worst <= GS1_REL and solve_rel <= GS1_REL):
        fail(f"GS1 on hpcg20: worst block rel {worst:.3e}, the solve's x "
             f"rel {solve_rel:.3e} against the plain route (limit {GS1_REL})")
    so = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    xs = x0o.clone()
    raw = [(blk[2].data_ptr(), *(t.data_ptr() for t in args),
            xs.data_ptr(), blk[0], blk[1] - blk[0], blk[3],
            sw.group_lanes(blk[5]), stream) for blk in blocks]

    def kernel():
        for a in raw:
            so.gdn_symgs_sweep(*a)

    def through(fn):
        def go():
            for blk in blocks:
                fn(*args, xs, blk)
        return go
    prods = [(args[1][blk[3]:blk[4]] * xs[args[0][blk[3]:blk[4]]], blk[2])
             for blk in blocks]
    ms, _ = turns({"kernel": kernel, "plain": through(sw.sweep_block_plain)},
                  reps={"kernel": 50, "plain": 10})
    wrapper_ms = cuda_ms(through(sw.sweep_block), reps=50)
    library_ms = cuda_ms(lambda: [torch.segment_reduce(
        p, "sum", offsets=o, initial=0.0) for p, o in prods], reps=10)
    nbytes = 2 * (8 * g.nnz + 16 * g.m)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    print(f"[17] GS1 one application ({len(blocks)} launches): "
          f"{ms['kernel']:.4f} ms (through sweep_block {wrapper_ms:.4f}), "
          f"plain sweep {ms['plain']:.4f} ms, torch.segment_reduce alone "
          f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} B); "
          f"worst block rel {worst:.2e}; gpu: {gpu}")
    return {"name": "symgs_sweep", "route": "cuda", "source": GS1_SOURCE,
            "replaces": GS1_REPLACES, "launches": launches,
            "launches_by_path": {"symgs hpcg20 solve": launches},
            "colors": len(sys_.blocks), "mismatches": 0,
            "max_rel_err": worst, "solve_rel_err": solve_rel,
            "ms": ms["kernel"], "wrapper_ms": wrapper_ms,
            "plain_ms": ms["plain"], "bound_ms": bound_ms,
            "bound_by": "bytes", "bytes": nbytes,
            "library": "torch.segment_reduce (the plain sweep's row sums)",
            "library_ms": library_ms}


def symgs_phase(dev, gpu: str, g, g16) -> dict:
    """Phase 17: SymGS at R-MAT-16 against the serial sweep; the R-MAT-20
    bench against an independent f64 sweep.  Each within the CLI's l2 <
    1e-4 and SYMGS_F64_L2, on colours that vc_check holds proper, and
    each launching GS1 once a colour block of each solve (gs1_solve).
    Then GS1 at hpcg20's shape (gs1_timing): the kernels line's entry,
    with the launches of all three paths."""
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.solvers.symgs import fill_inputs, symgs_solver
    from gardenia_tpu_torch.verify import l2_error, oracles

    def check(label, graph, colors, x, want, ref, t0):
        secs = time.perf_counter() - t0
        proper = oracles.vc_check(graph, colors)
        err = l2_error(x, want)
        print(f"[17] symgs {label}: {int(colors.max()) + 1} colours, "
              f"vc_check {'passes' if proper else 'FAILS'}; l2 error "
              f"{err:.3e} against {ref} ({secs:.1f} s; limits: the CLI's "
              f"1e-4, an f32 sweep's {SYMGS_F64_L2}); finite: "
              f"{bool(np.isfinite(x).all())}; gpu: {gpu}")
        if not proper:
            fail(f"symgs {label}: the colouring fed to it is not proper")
        if (not err < 1e-4 or not err < SYMGS_F64_L2
                or x.shape != (graph.m,) or not np.isfinite(x).all()):
            fail(f"symgs {label} disagrees with its f64 reference: l2 {err}")

    Ax, x0, b, diag, colors = fill_inputs(g16, device=dev)
    res, n16 = gs1_solve(
        f"rmat{SMOKE_SCALE}", 1, np.unique(colors).size,
        lambda: symgs_solver(g16, Ax, x0, b, diag, colors, device=dev))
    order = np.argsort(colors, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(colors))])
    t0 = time.perf_counter()
    expect = oracles.symgs_serial(g16, order, Ax, diag, x0, b, offsets)
    check(f"rmat{SMOKE_SCALE}", g16, colors, res.x.cpu().numpy(), expect,
          "the serial sweep", t0)
    inputs = fill_inputs(g, device=dev)
    solves = max(0, bench.WARMUP) + max(1, bench.ITERS)
    (record, _, res), n20 = gs1_solve(
        f"bench rmat{MAIN_SCALE}", solves, np.unique(inputs[4]).size,
        lambda: bench.bench_symgs(MAIN_SCALE, dev, g=g))
    print(json.dumps(record))
    t0 = time.perf_counter()
    want = symgs_reference(g, *inputs)
    check(f"bench rmat{MAIN_SCALE}", g, inputs[4], res.x.cpu().numpy(), want,
          "the f64 per-colour sweep", t0)
    entry = gs1_timing(dev, gpu)
    entry["launches_by_path"].update({f"symgs rmat{SMOKE_SCALE} solve": n16,
                                      f"symgs bench rmat{MAIN_SCALE}": n20})
    entry["launches"] = sum(entry["launches_by_path"].values())
    return entry


def sgd_reference(gr, epochs: int, step: float, lam: float):
    """(trace, user_lv, item_lv) of an independent float64 replica of the
    mini-batched epoch: the same shuffle, batches and inverse counts, the
    per-vertex sums as scipy.sparse products."""
    import scipy.sparse as sp
    from gardenia_tpu_torch.solvers.sgd import init_latent, num_items
    m, n, nnz = gr.m, num_items(gr), gr.nnz
    batches = min(64, nnz // 65536)
    per = -(-nnz // batches)
    src = np.repeat(np.arange(m), np.diff(gr.rowptr))
    dst = np.asarray(gr.colidx, np.int64)
    r = np.asarray(gr.weights, np.float64)
    order = np.random.default_rng(17).permutation(nnz)
    pad = batches * per - nnz
    order = np.concatenate([order, np.zeros(pad, np.int64)])
    valid = np.concatenate([np.ones(nnz), np.zeros(pad)])
    U = init_latent(m, 0).astype(np.float64)
    It = init_latent(n, 1).astype(np.float64)
    trace = []
    for _ in range(epochs):
        sq = 0.0
        for bt in range(batches):
            sl = order[bt * per:(bt + 1) * per]
            v = valid[bt * per:(bt + 1) * per]
            s, d = src[sl], dst[sl]
            nu = 1 / np.maximum(np.bincount(s, v, m)[s], 1)
            ni = 1 / np.maximum(np.bincount(d, v, n)[d], 1)
            us, it_ = U[s], It[d]
            delta = (r[sl] - (us * it_).sum(1)) * v
            sq += (delta * delta).sum()
            e = np.arange(len(sl))
            U = U + step * (sp.csr_matrix((delta * nu, (s, e)),
                                          shape=(m, len(sl))) @ it_)
            It = It + step * (sp.csr_matrix((delta * ni, (d, e)),
                                            shape=(n, len(sl))) @ us)
        U, It = U - step * lam * U, It - step * lam * It
        trace.append(np.sqrt(sq / nnz))
    return np.array(trace), U, It


def sgd_phase(dev, gpu: str, g, g16) -> None:
    """Phase 18: SGD at R-MAT-16, 4 epochs, against the f64 replica; the
    R-MAT-20 bench (10 epochs) with the CLI's monotone check."""
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.cli import sgd_trace_ok
    from gardenia_tpu_torch.solvers.sgd import DEFAULT_LAMBDA, sgd_solver
    gr16 = bench.sgd_graph(g16)
    res = sgd_solver(gr16, step=bench.SGD_STEP, max_iters=SGD_SMOKE_EPOCHS,
                     epsilon=0.0, init=bench.sgd_init(gr16, dev), device=dev)
    t0 = time.perf_counter()
    trace, U, It = sgd_reference(gr16, SGD_SMOKE_EPOCHS, bench.SGD_STEP,
                                 DEFAULT_LAMBDA)
    got = res.rmse.cpu().numpy()
    rel_t = float(np.abs(got - trace).max() / trace.max())
    rel_f = max(float(np.abs(a.cpu().numpy() - b).max() / np.abs(b).max())
                for a, b in ((res.user_lv, U), (res.item_lv, It)))
    print(f"[18] sgd rmat{SMOKE_SCALE}, {SGD_SMOKE_EPOCHS} epochs: trace "
          f"{[round(float(t), 6) for t in got]}, the f64 replica's "
          f"{[round(float(t), 6) for t in trace]} ({time.perf_counter() - t0:.1f}"
          f" s); worst rel diff: trace {rel_t:.3e} (limit {SGD_TRACE_REL}), "
          f"factors {rel_f:.3e} (limit {SGD_FACTOR_REL})")
    if not (rel_t < SGD_TRACE_REL and rel_f < SGD_FACTOR_REL
            and sgd_trace_ok(got)):
        fail("SGD disagrees with its f64 replica, or its trace is not "
             "monotone")
    record, _, res = bench.bench_sgd(MAIN_SCALE, dev, g=g)
    print(json.dumps(record))
    trace = res.rmse.cpu().numpy()[:res.iterations]
    final = float(trace[-1])
    gap = final / SGD_TPU_FINAL_RMSE - 1
    print(f"[18] sgd bench rmat{MAIN_SCALE}: {res.iterations} epochs, trace "
          f"finite and monotone: {sgd_trace_ok(trace)}; final RMSE {final} "
          f"(the TPU record's, for comparison only: {SGD_TPU_FINAL_RMSE}, "
          f"gap {gap:+.2%}); gpu: {gpu}")
    if not sgd_trace_ok(trace) or res.iterations != bench.SGD_EPOCHS:
        fail("the SGD bench's trace is not finite and monotone")


def sym_graph(n: int, src, dst):
    """The port's symmetric Graph of n vertices over the edges (src, dst),
    deduplicated, without self loops."""
    from gardenia_tpu_torch.core import build
    from gardenia_tpu_torch.core.graph import Graph
    s, d, _ = build.clean_edges(np.asarray(src), np.asarray(dst), num_rows=n,
                                symmetrize=True)
    rp, ci, _ = build.coo_to_csr(n, s, d, sorted_by_src=True)
    return Graph(rp, ci, num_cols=n, symmetric=True)


def kcl_hand_cases():
    """(label, Graph or (rowptr, colidx) of a DAG, the k to hold, the
    per-vertex counts at k or None) edge cases of Q1: no edge; cliques,
    whose DAG is by id (equal degrees), so vertex u starts C(n-1-u, k-1)
    k-cliques (K_12 and K_34 also at k = 6..8); K_{n,n} with a seeded
    random graph of 4n edges inside its second side, whose first-side
    vertices have out-degree exactly n: the warp shape's one and two
    words a row (32/33) and its edge (64/65), each W where the CTA
    shape's lanes a root at k = 4 change (128/129, 256/257), the tensor
    cores' first W (257) and the hubs' run (512/513), Q1's limit (1024;
    1025 takes the expansion); one hub of out-degree 1024 alone in the
    CTA shape, over a band DAG of out-degree 12; and ids that share one
    slot of the hash table (the last, so probes wrap): a vertex whose
    out-neighbours all do, whose rows hold more such ids that it lacks,
    half of them past its filter."""
    from math import comb
    from gardenia_tpu_torch.ops import kcl_count
    rng = np.random.default_rng(19)

    def clique(n):
        a, b = np.triu_indices(n, 1)
        return sym_graph(n, a, b), lambda k: np.array(
            [comb(n - 1 - u, k - 1) for u in range(n)], np.int64)

    def biclique_plus(n):
        a, b = np.divmod(np.arange(n * n), n)
        x, y = rng.integers(n, 2 * n, (2, 4 * n))
        return sym_graph(2 * n, np.concatenate([a, x]),
                         np.concatenate([n + b, y])), None

    def dag(rows, m):
        rowptr = np.zeros(m + 1, np.int64)
        rowptr[1:len(rows) + 1] = np.cumsum([len(r) for r in rows])
        rowptr[len(rows) + 1:] = rowptr[len(rows)]
        colidx = np.concatenate([np.asarray(sorted(r), np.int32)
                                 for r in rows])
        return rowptr, colidx

    def hub_alone(d=1024, band=12):
        rows = [range(1, d + 1)] + [range(i + 1, min(i + band, d) + 1)
                                    for i in range(1, d + 1)]
        return dag(rows, d + 1)

    def colliding(d):
        # ids with the last slot of a d-vertex table: d of them, spread over
        # the range, are vertex 0's row; up to d others inside its window
        # whose filter bits are members' (so every one probes the whole
        # cluster and misses) and d more that the filter stops fill its
        # members' rows
        bits = kcl_count.hash_bits(d)
        ids = np.arange(1, 1 << 25)
        ids = ids[kcl_count.hash_slot(ids, bits) == (1 << bits) - 1]
        members = ids[np.linspace(0, len(ids) - 1, d).astype(np.int64)]
        rest = ids[(ids > members[0]) & (ids < members[-1])
                   & ~np.isin(ids, members)]
        passes = np.isin(kcl_count.filter_bit(rest, bits),
                         kcl_count.filter_bit(members, bits))
        if passes.sum() < 16:
            fail(f"only {passes.sum()} ids pass a {d}-vertex filter")
        others = np.sort(np.concatenate([
            part[np.linspace(0, len(part) - 1, min(d, len(part)))
                 .astype(np.int64)]
            for part in (rest[passes], rest[~passes])]))
        rows = {0: members.tolist()}
        for i, v in enumerate(members):
            near = np.searchsorted(others, v)
            rows[int(v)] = sorted(set(members[i + 1:i + 9].tolist())
                                  | set(others[max(0, near - 4):near + 4]
                                        .tolist()))
        m = int(max(members[-1], others.max())) + 1
        keys = sorted(rows)
        lens = np.zeros(m, np.int64)
        lens[keys] = [len(rows[v]) for v in keys]
        rowptr = np.concatenate([[0], np.cumsum(lens)])
        colidx = np.concatenate([np.asarray(rows[v], np.int32)
                                 for v in keys])
        return rowptr, colidx

    k345 = (3, 4, 5)
    return ([("no edge, 64 vertices", sym_graph(64, [], []), k345,
              lambda k: np.zeros(64, np.int64))]
            + [(f"K_{n}", *clique(n)[:1], k345, clique(n)[1])
               for n in (5, 33, 64)]
            + [(f"K_{n}", *clique(n)[:1], (6, 7, 8), clique(n)[1])
               for n in (12, 34)]
            + [(f"K_{{{n},{n}}} + 4n random edges inside, d = {n}",
                biclique_plus(n)[0], k345, None)
               for n in (32, 33, 64, 65, 128, 129, 256, 257, 512, 513, 1024,
                         1025)]
            + [("one hub of d = 1024 alone over a band DAG", hub_alone(),
                k345, None)]
            + [(f"{d} out-neighbours sharing one hash slot, d = {d}",
                colliding(d), k345, None) for d in (60, 500)])


def q1_bytes(ldag, k: int) -> int:
    """What Q1's inputs and output need: the DAG's CSR, the launched
    vertex lists and the counts, each once."""
    from gardenia_tpu_torch.ops import kcl_count
    verts = sum(end - first for first, end, _ in
                kcl_count.launch_plan(ldag, k))
    return (8 * ldag.rowptr.numel() + 4 * ldag.colidx.numel() + 4 * verts
            + 8 * (ldag.rowptr.numel() - 1))


def q1_ops(ldag, k: int, lower_counts: dict) -> int:
    """The operations Q1's count needs on this DAG: a membership test a
    pair of an arc (u, w) of a launched u, min(d(u), d(w)) of them (the
    smaller side), and a word AND a W(u)-word row for each (l-1)-clique
    that a level extends, l = 4 .. k (lower_counts[l - 1]: the per-vertex
    (l-1)-clique counts, from Q1)."""
    import torch
    rp, ci = ldag.rowptr, ldag.colidx
    deg = rp[1:] - rp[:-1]
    src = torch.repeat_interleave(torch.arange(deg.numel(), device=rp.device),
                                  deg)
    tests = int(torch.where(deg[src] >= k - 1,
                            torch.minimum(deg[src], deg[ci.long()]), 0).sum())
    words = (deg + 31) // 32
    ands = sum(int((lower_counts[l - 1] * words).sum())
               for l in range(4, k + 1))
    return tests + ands


def kcl_phase(dev, gpu: str, g, g16):
    """Phase 19: Q1's sizes as the library exports them against the host's
    copies; Q1 against its plain version per vertex (hand cases, R-MAT-16
    at k = 3, 4, R-MAT-14 at k = 5), kcl_solver at R-MAT-16 against the TPU record, the
    R-MAT-20 kcl bench (the main path) with Q1's launches, Q1 timed beside
    its plain version and its bound, by degree class with the probe's
    split (scripts/probe_q1.py), and k = 3 through Q1 against tc_solver.
    Returns Q1's entry of the kernels line."""
    import torch
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.mining import kcl
    from gardenia_tpu_torch.ops import kcl_count
    from gardenia_tpu_torch.solvers.tc import tc_solver
    from scripts import probe_q1
    limits = kcl_count.kernel_limits()
    print(f"[19] Q1's limits as the library exports them: "
          f"{json.dumps(limits)}")
    ids = np.random.default_rng(7).integers(0, 2 ** 31 - 1, 64)
    for d in range(1, kcl_count.MAX_DEGREE + 1):
        bits = kcl_count.hash_bits(d)
        mine = {"hash_bits": bits,
                "slots": kcl_count.hash_slot(ids, bits).tolist(),
                "filter_bits": kcl_count.filter_bit(ids, bits).tolist(),
                "group_lanes": kcl_count.group_lanes(kcl_count.words(d)),
                "shared_bytes": kcl_count.shared_bytes(d)}
        if kcl_count.kernel_sizes(d, ids) != mine:
            fail(f"ops/kcl_count's sizes at d = {d} differ from the "
                 f"library's: {mine} vs {kcl_count.kernel_sizes(d, ids)}")
    print(f"[19] Q1's sizes (table bits, slots and filter bits, lanes a root,"
          f" shared bytes) equal the host's copies at d = 1.."
          f"{kcl_count.MAX_DEGREE};"
          f" shared bytes at d = 1024: {kcl_count.shared_bytes(1024)}")
    stats = {"cases": 0, "mismatches": 0, "max_abs_err": 0}

    def hold(label, src, k, want=None):
        """Q1 and its plain version on the same DAG, per vertex, exact
        (and the closed form where given); the counts, Q1's launch plan
        and the plain version's ms."""
        if isinstance(src, tuple):
            ldag = kcl_count.prepare(torch.from_numpy(src[0]).to(dev),
                                     torch.from_numpy(src[1]).to(dev))
        else:
            ldag = kcl.local_dag(src, dev)
        route = kcl_count.route(ldag.max_degree, k)
        if route != "q1":
            got = kcl.kcl_solver(src, k, force_expand=True, device=dev)
            print(f"[19] {label}, k {k}: widest out-degree "
                  f"{ldag.max_degree}, route {kcl.LAST_ROUTE}, {got} cliques")
            if kcl.LAST_ROUTE != "expand":
                fail(f"{label}: out-degree {ldag.max_degree} did not take "
                     "the expansion")
            return None, None, None
        before = kcl_count.LAUNCHES
        got = kcl_count.local_count(ldag, k)
        launched = kcl_count.LAUNCHES - before
        plain, plain_ms = timed_once(
            lambda: kcl_count.local_count_plain(ldag, k))
        bad = int((got != plain).sum())
        if want is not None:
            bad += int((got.cpu().numpy() != want(k)).sum())
        err = int((got - plain).abs().max()) if got.numel() else 0
        stats["cases"] += 1
        stats["mismatches"] += bad
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        plan = kcl_count.launch_plan(ldag, k)
        print(f"[19] Q1 {label}, k {k}: {int(got.sum())} cliques, widest "
              f"out-degree {ldag.max_degree}, {launched} launches, plan "
              f"(first, end, dmax) {json.dumps(plan)}; {bad} vertices "
              f"differ from the plain version's (plain {plain_ms:.1f} ms)")
        if bad or launched != len(plan):
            fail(f"Q1 disagrees with its plain version on {label} at k {k}")
        return got, plan, plain_ms

    for label, src, ks, want in kcl_hand_cases():
        for k in ks:
            hold(label, src, k, want)
    counts16, plain16_ms = {}, {}
    for k in (3, 4):
        counts16[k], _, plain16_ms[k] = hold(f"rmat{SMOKE_SCALE}", g16, k)
    # k = 5 is off the main path (k = 4): held at R-MAT-14, where R-MAT-16's
    # plain expansion took 12.5 s of the run; it must launch both shapes
    from gardenia_tpu_torch.core.generate import generate_graph
    _, plan5, _ = hold(f"rmat{KCL_K5_SCALE}", generate_graph(
        "rmat", scale=KCL_K5_SCALE, degree=16, symmetrize=True), 5)
    if not (plan5 and plan5[0][2] > kcl_count.WARP_DEGREE
            and plan5[-1][2] <= kcl_count.WARP_DEGREE):
        fail(f"Q1 at k = 5 on rmat{KCL_K5_SCALE} did not launch both the CTA "
             f"and the warp shape: plan {plan5}")
    total16 = kcl.kcl_solver(g16, 4, device=dev)
    print(f"[19] kcl_solver rmat{SMOKE_SCALE} k 4: {total16} (the TPU "
          f"record: {bench.KCL4_RECORD[SMOKE_SCALE]}), route {kcl.LAST_ROUTE}")
    if total16 != bench.KCL4_RECORD[SMOKE_SCALE] or kcl.LAST_ROUTE != "q1":
        fail("kcl_solver at R-MAT-16 misses the record or Q1")

    # the main path: the kcl bench, Q1's launches counted around it
    kcl_count.LAUNCHES = 0
    record, _, total = bench.bench_kcl(MAIN_SCALE, dev, g=g)
    launches = kcl_count.LAUNCHES
    print(json.dumps(record))
    ldag = kcl.local_dag(g, dev)
    plan = kcl_count.launch_plan(ldag, 4)
    solves = sum(bench.mining_repeats(MAIN_SCALE).values())
    print(f"[19] kcl bench rmat{MAIN_SCALE}: {total} 4-cliques (the TPU "
          f"record: {bench.KCL4_RECORD[MAIN_SCALE]}), route "
          f"{record['detail']['route']}, Q1 launches {launches} over {solves}"
          f" solves, plan (first, end, dmax) {json.dumps(plan)}; the "
          f"widest CTA run: {json.dumps(kcl_count.cta_info(plan[0][2]))}")
    if not (record["detail"]["correct"] and launches > 0
            and launches == solves * len(plan)):
        fail("the kcl bench missed the record, Q1, or its launches")
    # k = 3 through Q1 against the triangle route
    for label, graph, want in ((f"rmat{SMOKE_SCALE}", g16, None),
                               (f"rmat{MAIN_SCALE}", g,
                                bench.TC_RECORD[MAIN_SCALE])):
        tri = kcl.kcl_solver(graph, 3, force_expand=True, device=dev)
        route = kcl.LAST_ROUTE
        tc = tc_solver(graph, device=dev)
        print(f"[19] kcl_solver {label} k 3 force_expand: {tri} on route "
              f"{route}; tc_solver {tc}" + (f"; the record {want}"
                                            if want else ""))
        if tri != tc or route != "q1" or (want and tri != want):
            fail(f"k = 3 through Q1 disagrees with tc_solver on {label}")

    # Q1 timed on the main path's DAG, beside its plain version; the bound
    lower = {3: kcl_count.local_count(ldag, 3)}
    ms = cuda_ms(lambda: kcl_count.local_count(ldag, 4), reps=5, warmup=1)
    ms16 = cuda_ms(lambda: kcl_count.local_count(kcl.local_dag(g16, dev), 4),
                   reps=5, warmup=1)
    # by degree class: the shipped source and its copies without the count
    # and without the lookups (the probe's split), each class one launch
    split = probe_q1.split(ldag, 4)
    print(f"[19] Q1 k 4 at rmat{MAIN_SCALE} by degree class (CUDA events; "
          f"full, build = no count, stream = no count and every lookup a "
          f"miss; ms): " + json.dumps(split["classes"]))
    plain20, plain20_ms = timed_once(
        lambda: kcl_count.local_count_plain(ldag, 4))
    got20 = kcl_count.local_count(ldag, 4)
    bad20 = int((got20 != plain20).sum())
    stats["cases"] += 1
    stats["mismatches"] += bad20
    stats["max_abs_err"] = max(stats["max_abs_err"],
                               int((got20 - plain20).abs().max()))
    b_ms, b_by = bound(q1_bytes(ldag, 4), q1_ops(ldag, 4, lower))
    ldag16 = kcl.local_dag(g16, dev)
    b16_ms, _ = bound(q1_bytes(ldag16, 4), q1_ops(ldag16, 4, counts16))
    print(f"[19] gpu: {gpu}")
    print(f"[19] Q1 k 4 at rmat{MAIN_SCALE}: {ms:.3f} ms (CUDA events), plain "
          f"version {plain20_ms:.1f} ms (one call; {bad20} vertices differ), "
          f"bound {b_ms:.4f} ms ({b_by}: {q1_bytes(ldag, 4)} B, "
          f"{q1_ops(ldag, 4, lower)} tests and word ANDs); at "
          f"rmat{SMOKE_SCALE}: {ms16:.3f} ms, plain {plain16_ms[4]:.1f} ms, "
          f"bound {b16_ms:.4f} ms")
    if bad20:
        fail("Q1 disagrees with its plain version at R-MAT-20")
    return {"name": "kcl_local_count", "route": "cuda", "source": Q1_SOURCE,
            "replaces": Q1_REPLACES, "launches": launches,
            "launches_by_path": {f"kcl bench rmat{MAIN_SCALE}": launches},
            **stats, "k": 4, "plan": plan,
            "resources": kcl_count.cta_info(plan[0][2]),
            "ms_by_class": {c: row["full"] for c, row in
                            split["classes"].items()},
            "split_by_class": {c: {part: row[f"split_{part}"] for part in
                                   ("stream", "build", "count")}
                               for c, row in split["classes"].items()},
            "ms": ms, "plain_ms": plain20_ms, "bound_ms": b_ms,
            "bound_by": b_by, "ms_rmat16": ms16,
            "plain_ms_rmat16": plain16_ms[4], "bound_ms_rmat16": b16_ms,
            "library_ms": None}


def motif_phase(dev, gpu: str, g, g16, tc_per_solve: dict) -> dict:
    """Phase 20: the R-MAT-16 4-census against the TPU record, its wedge
    streams against the host oracles, the 3-census and the 4-census bench
    at R-MAT-20 (a main path: Q1's and the TC kernels' launches counted
    around it, runs or classes x solves, tc_per_solve being the TC bench's
    launches a solve); the host-oracle branch must not run.  Returns the
    bench's launches by kernel and its census."""
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.core.generate import generate_graph
    from gardenia_tpu_torch.mining import kcl, motif, wedgestream
    from gardenia_tpu_torch.ops import kcl_count
    from gardenia_tpu_torch.ops import tc_count as tcc
    record, _, census = bench.bench_motif(SMOKE_SCALE, dev, g=g16)
    print(json.dumps(record))
    print(f"[20] motif bench rmat{SMOKE_SCALE}: census "
          f"{'equals' if record['detail']['correct'] else 'DIFFERS from'} "
          f"the TPU record, aggregates {record['detail']['aggregates']}")
    if not record["detail"]["correct"] or \
            record["detail"]["aggregates"] != "streams" or \
            record["detail"]["kcl_route"] != "q1":
        fail("the R-MAT-16 4-census differs from the TPU record or missed "
             "Q1")
    # the streams against the host oracles: the per-edge triangles at
    # R-MAT-16 and R-MAT-14 (the card's wedge sweep), c_non at R-MAT-14,
    # where codegree_cycle_quads makes one numpy pass of 77.8M wedges (at
    # R-MAT-16, 622.6M wedges in 4 passes, minutes on one core; there the
    # census's 4-cycles and diamonds equal to the record hold c_non, and
    # [21] holds the 4-cycles at R-MAT-12 to the pattern engine's
    # rectangles)
    g14 = generate_graph("rmat", scale=CC_UNIFORM_SCALE, degree=16,
                         symmetrize=True)
    for label, graph, quads_too in ((f"rmat{SMOKE_SCALE}", g16, False),
                                    (f"rmat{CC_UNIFORM_SCALE}", g14, True)):
        t0 = time.perf_counter()
        c_non, tri_u, _, _ = wedgestream.wedge_stream_stats(graph, device=dev)
        streams_s = time.perf_counter() - t0
        src = np.repeat(np.arange(graph.m), np.diff(graph.rowptr))
        t0 = time.perf_counter()
        tri = motif.edge_triangle_counts(graph, chunk=TRI_CHUNK,
                                         device=dev)[src < graph.colidx]
        tri_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        quads = motif.codegree_cycle_quads(graph) if quads_too else None
        quads_s = time.perf_counter() - t0
        same = np.array_equal(tri_u, tri) and quads in (None, c_non)
        print(f"[20] wedge streams {label}: c_non {c_non}, sum tri_u "
              f"{int(tri_u.sum())} ({streams_s:.2f} s); the host oracles' "
              + (f"c_non {quads} ({quads_s:.1f} s, numpy), " if quads_too
                 else "") + f"sum tri {int(tri.sum())} ({tri_s:.2f} s, the "
              f"card's wedge sweep): {'equal' if same else 'NOT equal'}")
        if not same:
            fail(f"the wedge streams disagree with the host oracles on "
                 f"{label}")
    census3 = motif.motif_solver(g, 3, device=dev)
    deg = np.diff(g.rowptr).astype(np.int64)
    want3 = {"3-path": int((deg * (deg - 1) // 2).sum())
             - 3 * bench.TC_RECORD[MAIN_SCALE],
             "3-triangle": bench.TC_RECORD[MAIN_SCALE]}
    print(f"[20] motif rmat{MAIN_SCALE} k 3: {json.dumps(census3)}")
    if census3 != want3:
        fail(f"the R-MAT-20 3-census is not {want3}")
    # the main path: the motif bench, the kernels' launches counted
    # around it
    kcl_count.LAUNCHES = 0
    tcc.reset_launches()
    record, _, _ = bench.bench_motif(MAIN_SCALE, dev, g=g)
    launches = {"kcl_local_count": kcl_count.LAUNCHES, **tcc.LAUNCHES}
    print(json.dumps(record))
    d = record["detail"]
    solves = sum(bench.mining_repeats(MAIN_SCALE).values())
    q1_runs = len(kcl_count.launch_plan(kcl.local_dag(g, dev), 4))
    want = {"kcl_local_count": q1_runs * solves,
            **{name: n * solves for name, n in tc_per_solve.items()}}
    print(f"[20] motif bench rmat{MAIN_SCALE}: aggregates {d['aggregates']},"
          f" {d['n_parts']} + {d['n_qparts']} stream partitions, 4-cliques "
          f"on route {d['kcl_route']}, launches {json.dumps(launches)} over "
          f"{solves} solves (launches a solve x solves: {json.dumps(want)}), "
          f"4-cliques and triangles "
          f"{'hold' if d['correct'] else 'do NOT hold'}; gpu: {gpu}")
    if not d["correct"]:
        fail("the R-MAT-20 4-census misses its holds")
    if launches != want or 0 in launches.values():
        fail(f"the motif bench's launches {launches} are not runs x "
             f"solves {want}")
    return launches, d["census"]


def induced_fives(g, name: str, dev, block: int = 1 << 26) -> int:
    """The induced pentagons or houses of the symmetric graph g by dense
    0/1 products, independent of the pattern engine.  Around each vertex
    c, with N its neighbours and M the rest but c: a pentagon c-b-a-e-d
    has b, d in N not adjacent, a and e in M, a ~ b, a ~ e, e ~ d and no
    other edge; a house with roof c is the same with b ~ d.  For the
    ordered pair (b, d), u[b, d] = A[b, M] * (1 - A[d, M]) marks the a's,
    and u[b, d] @ A[M, M] . u[d, b] counts the (a, e).  Each pentagon
    comes 10 times (5 vertices, 2 orders), each house twice (its roof is
    its one vertex whose two neighbours are adjacent).  f32 is exact
    while |V|^2 < 2^24: no sum of a pair exceeds |V|^2."""
    import torch
    A = torch.zeros((g.m, g.m), dtype=torch.float32, device=dev)
    src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    A[torch.from_numpy(src).to(dev), torch.from_numpy(
        g.colidx.astype(np.int64)).to(dev)] = 1
    total = 0.0
    for c in range(g.m):
        nb = torch.from_numpy(
            g.colidx[g.rowptr[c]:g.rowptr[c + 1]].astype(np.int64)).to(dev)
        d = nb.numel()
        if d < 2:
            continue
        rest = A[c] == 0
        rest[c] = False
        X = A[nb][:, rest]
        Amm = A[rest][:, rest]
        pair = A[nb][:, nb]
        if name == "pentagon":
            pair = 1 - pair - torch.eye(d, device=dev)
        step = max(1, block // max(1, d * X.shape[1]))
        for lo in range(0, d, step):
            hi = min(d, lo + step)
            U = X[lo:hi, None, :] * (1 - X[None, :, :])        # u[b, d]
            V = X[None, :, :] * (1 - X[lo:hi, None, :])        # u[d, b]
            T = (U.reshape(-1, X.shape[1]) @ Amm).view_as(U)
            total += float(((T * V).sum(-1).double()
                            * pair[lo:hi].double()).sum())
    return int(round(total)) // (10 if name == "pentagon" else 2)


def sgl_phase(dev, gpu: str, g, g16, census20: dict) -> dict:
    """Phase 21: SGL diamond's bench at R-MAT-16 against the TPU record and
    at R-MAT-20 (a main path: Q1's launches counted around it, runs x
    solves) against the port's recorded census and [20]'s; the pattern
    engine on the card: diamond against the formula and rectangle against
    the 4-census's 4-cycles at R-MAT-12, pentagon and house at R-MAT-10
    against induced_fives' dense products and at R-MAT-8 against the
    same engine on CPU tensors; every pattern against sgl_verifier on a
    30-vertex graph.
    Returns Q1's launches in the R-MAT-20 bench."""
    import torch
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.core.generate import generate_graph
    from gardenia_tpu_torch.mining import kcl, motif, sgl
    from gardenia_tpu_torch.mining.pattern import PATTERNS
    from gardenia_tpu_torch.ops import kcl_count
    record, _, _ = bench.bench_sgl(SMOKE_SCALE, dev, g=g16)
    print(json.dumps(record))
    d = record["detail"]
    print(f"[21] sgl bench rmat{SMOKE_SCALE}: {d['count']} diamonds (the TPU "
          f"record: {bench.SGL_DIAMOND_RECORD[SMOKE_SCALE]}), triangles from "
          f"the {d['route']}, 4-cliques on route {d['kcl_route']}")
    if not d["correct"] or d["route"] != "streams":
        fail("SGL diamond at R-MAT-16 misses the TPU record or the streams")
    # the main path: the sgl bench on [20]'s graph, Q1's launches counted
    kcl_count.LAUNCHES = 0
    record, _, total = bench.bench_sgl(MAIN_SCALE, dev, g=g)
    launches = kcl_count.LAUNCHES
    print(json.dumps(record))
    d = record["detail"]
    solves = sum(bench.mining_repeats(MAIN_SCALE).values())
    runs = len(kcl_count.launch_plan(kcl.local_dag(g, dev), 4))
    print(f"[21] sgl bench rmat{MAIN_SCALE}: {total} diamonds (the port's "
          f"4-census: {SGL_DIAMOND_RMAT20}; [20]'s census: "
          f"{census20['4-diamond']}), triangles from the {d['route']}, "
          f"4-cliques on route {d['kcl_route']}, Q1 launches {launches} over "
          f"{solves} solves ({runs} runs a solve), solve {d['ms']:.1f} ms, "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; gpu: {gpu}")
    if not (d["correct"] and total == SGL_DIAMOND_RMAT20
            == census20["4-diamond"]):
        fail("SGL diamond at R-MAT-20 misses its holds")
    if launches != runs * solves:
        fail(f"Q1's launches in the sgl bench {launches} != {runs} x "
             f"{solves}")
    # the pattern engine on the card
    g12 = generate_graph("rmat", scale=12, degree=16, symmetrize=True)
    engine, engine_s = {}, {}
    for name in ("diamond", "rectangle"):
        t0 = time.perf_counter()
        engine[name] = sgl.sgl_solver(g12, name, use_formula=False,
                                      device=dev)
        engine_s[name] = time.perf_counter() - t0
    formula = sgl.sgl_solver(g12, "diamond", device=dev)
    cycles = motif.motif_solver(g12, 4, device=dev)["4-cycle"]
    print(f"[21] pattern engine rmat12: diamond {engine['diamond']} "
          f"({engine_s['diamond']:.2f} s; the formula: {formula}), "
          f"rectangle {engine['rectangle']} ({engine_s['rectangle']:.2f} s;"
          f" the 4-census's 4-cycles: {cycles})")
    if engine["diamond"] != formula or engine["rectangle"] != cycles:
        fail("the pattern engine disagrees with the formula or the census "
             "at R-MAT-12")
    g10 = generate_graph("rmat", scale=10, degree=16, symmetrize=True)
    g8 = generate_graph("rmat", scale=8, degree=16, symmetrize=True)
    for name in ("pentagon", "house"):
        t0 = time.perf_counter()
        n10 = sgl.sgl_solver(g10, name, device=dev)
        s10 = time.perf_counter() - t0
        t0 = time.perf_counter()
        dense10 = induced_fives(g10, name, dev)
        dense_s = time.perf_counter() - t0
        on_card = sgl.sgl_solver(g8, name, device=dev)
        on_cpu = sgl.sgl_solver(g8, name, device="cpu")
        print(f"[21] {name}: rmat10 {n10} on the card ({s10:.2f} s), dense "
              f"products {dense10} ({dense_s:.2f} s); rmat8 {on_card} on the "
              f"card, {on_cpu} on CPU tensors")
        if n10 != dense10:
            fail(f"{name} at R-MAT-10 differs from the dense products")
        if on_card != on_cpu:
            fail(f"{name} on the card differs from CPU tensors")
    g30 = sym_graph(30, *np.random.default_rng(30).integers(0, 30, (2, 150)))
    for name in sorted(PATTERNS):
        got = sgl.sgl_solver(g30, name, device=dev)
        want = sgl.sgl_verifier(g30, name)
        if got != want:
            fail(f"{name} on a 30-vertex graph: {got}, sgl_verifier {want}")
    print(f"[21] every pattern on a 30-vertex graph equals sgl_verifier; "
          f"peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def fsm_scipy_aggregates(g, lab: np.ndarray, L: int):
    """fsm_agg's five label aggregates of g by scipy, int64, on the host
    CSR in g's own vertex order (they are sums by label, so the order does
    not matter)."""
    from gardenia_tpu_torch.mining import fsm_agg
    A = scipy_csr(g, np.ones(g.nnz, np.int64))
    O = (lab[:, None] == np.arange(L)[None, :]).astype(np.int64)
    C = A @ O
    E1, E2 = (C >= 1).astype(np.int64), (C >= 2).astype(np.int64)
    plb, plc = np.concatenate([np.stack(c) for c in
                               fsm_agg.lane_chunks(L)], axis=1)
    H1 = ((A @ (O[:, plb] * E1[:, plc])) >= 1).astype(np.int64)
    H2 = ((A @ (O[:, plb] * E2[:, plc])) >= 1).astype(np.int64)
    return (O.T @ H1, O.T @ H2, O.T @ (E1[:, plb] * E1[:, plc]), O.T @ E2,
            O.T @ E1)


def fsm_phase(dev, gpu: str, g, g16) -> dict:
    """Phase 22: FSM's bench at R-MAT-16 against the TPU record, its five
    label aggregates against scipy's; at R-MAT-20 (a main path: K1's
    launches by route and the split's counted around it, 3 applies x
    panel arrays x solves on the 'tc' route, no split) against the TPU
    record, its aggregates against the panel-free route (ops/spmv.
    spmv_batched over the CSR, no K1); K1 held to its plain version on
    the bench's operands (S = L and L*L, bf16 0/1: exact) and timed there
    by CUDA events beside the plain version and its bound; fsm_solver at
    k = 2 and 3 (gSpan) on random labels on the card against CPU tensors.  Returns K1's entry
    numbers for the kernels line."""
    import torch
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.core import views
    from gardenia_tpu_torch.core.generate import generate_graph
    from gardenia_tpu_torch.mining import fsm, fsm_agg
    from gardenia_tpu_torch.ops import panel, spmv
    record, _, _ = bench.bench_fsm(SMOKE_SCALE, dev, g=g16)
    print(json.dumps(record))
    lab16, L16 = fsm_agg.label_ids(g16)
    got16, _ = fsm_agg.fsm_aggregates(g16, device=dev)
    want16 = fsm_scipy_aggregates(g16, lab16, L16)
    same16 = all(np.array_equal(a, b) for a, b in zip(got16, want16))
    found16 = record["detail"]["frequent_patterns"]
    print(f"[22] fsm bench rmat{SMOKE_SCALE}: {found16} frequent patterns "
          f"(the TPU record: "
          f"{bench.FSM2_MINSUP5000_RECORD[SMOKE_SCALE]}), L {L16}; the five "
          f"aggregates {'equal' if same16 else 'DIFFER from'} scipy's")
    if not record["detail"]["correct"] or not same16:
        fail("FSM at R-MAT-16 misses the TPU record or scipy's aggregates")
    # the main path: the fsm bench on [20]'s graph, K1's launches counted
    panel.LAUNCHES.update(simt=0, tc=0)
    panel.SPLIT_LAUNCHES["split"] = 0
    record, _, total = bench.bench_fsm(MAIN_SCALE, dev, g=g)
    routes, split = dict(panel.LAUNCHES), panel.SPLIT_LAUNCHES["split"]
    print(json.dumps(record))
    d = record["detail"]
    _, hyb, _ = views.relabeled_hybrid(g, dev, reverse=False)
    arrays = len(hyb.dense)
    solves = 2                       # bench_fsm: one warm-up, one timed
    # an apply for the label counts, two a lane chunk
    want_tc = (1 + 2 * d["lane_chunks"]) * arrays * solves
    print(f"[22] fsm bench rmat{MAIN_SCALE}: {total} frequent patterns (the "
          f"TPU record: {bench.FSM2_MINSUP5000_RECORD[MAIN_SCALE]}), L "
          f"{d['labels']}, {d['lane_chunks']} lane chunks, K1 launches "
          f"{json.dumps(routes)} over {solves} solves (3 applies x {arrays} "
          f"arrays x solves: {want_tc} 'tc'), split launches {split}, solve "
          f"{d['ms']:.1f} ms, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; gpu: {gpu}")
    if not d["correct"] or total != bench.FSM2_MINSUP5000_RECORD[MAIN_SCALE]:
        fail("FSM at R-MAT-20 misses the TPU record")
    if routes != {"simt": 0, "tc": want_tc} or split:
        fail(f"K1's launches in the fsm bench {routes}, split {split}: not "
             f"{want_tc} on 'tc' and none else")
    # the aggregates against the panel-free route, in g's own order
    lab, L = fsm_agg.label_ids(g)
    rows, cols = views.coo_sorted(g, dev)
    offsets = spmv.row_offsets(rows, g.m)

    def csr_apply(x2d):
        return torch.cat([spmv.spmv_batched(rows, cols, x2d[:, c:c + 32],
                                            num_rows=g.m, offsets=offsets)
                          for c in range(0, x2d.shape[1], 32)], dim=1)
    panel.LAUNCHES.update(simt=0, tc=0)
    want20 = fsm_agg.aggregates(csr_apply, torch.from_numpy(lab).to(dev), L)
    if sum(panel.LAUNCHES.values()):
        fail("the panel-free route launched K1")
    got20, _ = fsm_agg.fsm_aggregates(g, device=dev)
    same20 = all(np.array_equal(a, b) for a, b in zip(got20, want20))
    print(f"[22] the five aggregates at rmat{MAIN_SCALE} "
          f"{'equal' if same20 else 'DIFFER from'} the panel-free route's")
    if not same20:
        fail("the R-MAT-20 aggregates differ from the panel-free route's")
    # K1 on the bench's operands: the one-hot labels (S = L) and the
    # lane matrix B1 (S = L * L), against its plain version and timed
    apply, old_of_new = fsm_agg.hybrid_apply(g, dev)
    lab_d = torch.from_numpy(lab).to(dev)[old_of_new]
    onehot = lab_d[:, None] == torch.arange(L, device=dev)[None, :]
    E1 = apply(onehot.to(torch.bfloat16)) >= 0.5
    (plb, plc), = [(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
                   for a, b in fsm_agg.lane_chunks(L)]
    ops_ = {L: onehot.to(torch.bfloat16),
            L * L: (onehot[:, plb] & E1[:, plc]).to(torch.bfloat16)}
    qx = (g.m + 127) // 128
    pairs = [(p.panel, p.src) for p in hyb.dense]
    slots = sum(p.src.shape[0] for p in hyb.dense)
    panel_bytes = sum(p.panel.numel() * p.panel.element_size()
                      + p.src.numel() * 4 for p in hyb.dense)
    _, _, nz = panel_work(hyb, 0)
    out = {"mismatches": 0, "by_columns": {}}
    for S, x2d in ops_.items():
        x3 = torch.zeros((qx * 128, S), dtype=torch.bfloat16, device=dev)
        x3[:g.m] = x2d
        x3 = x3.view(qx, 128, S)
        bad = sum(int((k_ != p_).sum()) for k_, p_ in zip(
            panel.dense_panel_matmul_arrays(pairs, x3, S),
            [panel.dense_panel_matmul_plain(pn, src, x3, S)
             for pn, src in pairs]))
        out["mismatches"] += bad
        ms_, _ = turns({"kernel": lambda: panel.dense_panel_matmul_arrays(
            pairs, x3, S), "plain": lambda: [
            panel.dense_panel_matmul_plain(pn, src, x3, S)
            for pn, src in pairs]}, reps={"kernel": 5, "plain": 1})
        b_ms, b_by = bound(panel_bytes + qx * 128 * S * 2
                           + slots * 128 * S * 4, 2 * nz * S,
                           TENSOR_BF16_OPS_PER_S)
        # the library's yardstick on the same operand, f32 values as at
        # S = 128 ([11]), beside K1 + the slot index_add_
        lib = library_yardstick(hyb, x3, qx, torch.float32,
                                dense_part(hyb, x3, qx), K1_REL_LIMIT)
        dense_ms = cuda_ms(lambda: dense_part(hyb, x3, qx), reps=3, warmup=1)
        out["by_columns"][S] = {"ms": ms_["kernel"], "plain_ms": ms_["plain"],
                  "bound_ms": b_ms, "bound_by": b_by,
                  "padded_columns": panel.padded_columns(S),
                  "dense_with_index_add_ms": dense_ms, **lib}
        print(f"[22] K1 'tc' on the fsm operand S = {S} (padded to "
              f"{panel.padded_columns(S)}): {bad} elements differ from the "
              f"plain version; kernel {ms_['kernel']:.3f} ms, plain "
              f"{ms_['plain']:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"{b_ms / ms_['kernel']:.2f} of it; library yardstick "
              f"(torch.sparse_bsr_tensor f32 @ operand) {json.dumps(lib)}, "
              f"K1 + the slot index_add_ {dense_ms:.3f} ms; gpu: {gpu}")
        torch.cuda.empty_cache()
    if out["mismatches"]:
        fail("K1 differs from its plain version on the fsm operands")
    del ops_, E1, onehot
    # gSpan (k = 3) on the card against CPU tensors
    gk = generate_graph("rmat", scale=FSM_GSPAN_SCALE, degree=16,
                        symmetrize=True)
    labk = np.random.default_rng(FSM_GSPAN_SCALE).integers(
        0, FSM_GSPAN_LABELS, gk.m)
    by_k = {}
    for k in (2, 3):
        t0 = time.perf_counter()
        on_card = fsm.fsm_solver(gk, k, FSM_GSPAN_MINSUP, labk, device=dev)
        card_s = time.perf_counter() - t0
        on_cpu = fsm.fsm_solver(gk, k, FSM_GSPAN_MINSUP, labk, device="cpu")
        by_k[k] = on_card
        print(f"[22] fsm_solver k {k} minsup {FSM_GSPAN_MINSUP} "
              f"rmat{FSM_GSPAN_SCALE}, {FSM_GSPAN_LABELS} random labels: "
              f"{on_card} on the card ({card_s:.1f} s), {on_cpu} on CPU "
              f"tensors; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if on_card != on_cpu:
            fail(f"fsm_solver at k = {k} on the card differs from CPU "
                 f"tensors")
    if not by_k[3] > by_k[2] > 0:
        fail("gSpan's level 3 found no frequent pattern")
    out["launches"] = routes["tc"]
    return out


def replay_collectives(mesh, calls: dict, nbytes: dict, reps: int = 3
                       ) -> float:
    """ms of a solve's collectives replayed alone: as many all_gathers and
    all_reduces as it made, each of int32 elements of its mean size,
    host clock between synchronizes, the mean of reps."""
    import torch
    n_ag, n_ar = calls["all_gather"], calls["all_reduce"]
    ag = torch.zeros(max(1, nbytes["all_gather"] // max(1, n_ag)
                         // mesh.size // 4), dtype=torch.int32,
                     device=mesh.device)
    ar = torch.zeros(max(1, nbytes["all_reduce"] // max(1, n_ar) // 4),
                     dtype=torch.int32, device=mesh.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        for _ in range(n_ag):
            mesh.all_gather(ag)
        for _ in range(n_ar):
            mesh.all_reduce(ar)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def record_k1(run):
    """(run()'s result, K1's calls in the run under the operand they read
    that had the most nonzeros: {"x3d": a copy of it, "S", "nonzeros",
    "calls": [(panel, src, out)]}, or None when K1 was not called).  Every
    K1 call goes through ops/panel.dense_panel_matmul_arrays, which is
    wrapped for the run."""
    import torch
    from gardenia_tpu_torch.ops import panel
    keep, groups = panel.dense_panel_matmul_arrays, []

    def rec(arrays, x3d, S):
        arrays = list(arrays)
        outs = keep(arrays, x3d, S)
        if not groups or groups[-1]["of"] is not x3d:
            # a new operand: of the ones before it, keep the densest
            groups[:] = [max(groups, key=lambda c: c["nonzeros"])] \
                if groups else []
            groups.append({"of": x3d, "x3d": x3d.clone(), "S": S,
                           "nonzeros": int(torch.count_nonzero(x3d)),
                           "calls": []})
        groups[-1]["calls"] += [(pn, src, y)
                                for (pn, src), y in zip(arrays, outs)]
        return outs

    panel.dense_panel_matmul_arrays = rec
    try:
        res = run()
    finally:
        panel.dense_panel_matmul_arrays = keep
    if not groups:
        return res, None
    best = max(groups, key=lambda c: c["nonzeros"])
    del best["of"]
    return res, best


def hold_k1_calls(rec: dict) -> dict:
    """K1's outputs recorded on a rank's path against its plain version
    (ops/panel.dense_panel_matmul_plain) on the same panel array, block
    table and operand, on the card: exact for a 0/1 bf16 operand on
    integer panels (every sum an integer), else max|diff| / max|y| under
    K1_REL_LIMIT; every block id of the table inside the operand."""
    import torch
    from gardenia_tpu_torch.ops import panel
    x, S = rec["x3d"], rec["S"]
    binary = x.dtype == torch.bfloat16 and bool(((x == 0) | (x == 1)).all())
    st = {"arrays": 0, "S": S, "operand": str(x.dtype)[6:],
          "operand_nonzeros": rec["nonzeros"], "max_abs_err": 0.0,
          "max_rel_err": 0.0, "mismatches": 0}
    for pn, src, y_k in rec["calls"]:
        y_p = panel.dense_panel_matmul_plain(pn, src, x, S)
        in_range = not src.numel() or (int(src.min()) >= 0 and
                                       int(src.max()) < x.shape[0])
        if y_k.shape != y_p.shape or not in_range:
            st["mismatches"] += 1
            continue
        err = float((y_k - y_p).abs().max()) if y_p.numel() else 0.0
        rel = err / max(1e-30, float(y_p.abs().max())) if y_p.numel() \
            else 0.0
        exact = binary and pn.dtype != torch.float32
        st["arrays"] += 1
        st["max_abs_err"] = max(st["max_abs_err"], err)
        st["max_rel_err"] = max(st["max_rel_err"], rel)
        st["mismatches"] += int(err != 0 if exact else
                                not (np.isfinite(rel) and rel < K1_REL_LIMIT))
        del y_p
    return st


def hold_shard_apply(gr, sh, x3d) -> dict:
    """A rank's whole shard (rows padded to rows_per_shard, columns the
    global padded vertex space) applied by spmv_hybrid on the card, K1 on
    its panels plus the ELL remainder, to the all-gathered padded operand
    that K1 read; against scipy's f64 product of the graph's in-edge rows
    [lo, hi) with the same operand in global order, element by element.
    Rows past hi - lo must come out 0."""
    import scipy.sparse as sp
    from gardenia_tpu_torch.ops.bsr import spmv_hybrid
    r = sh.ranges
    x = x3d.reshape(-1)[:r.padded_size()].float().contiguous()
    y = spmv_hybrid(sh.mat, x, num_rows=r.rows_per_shard).cpu().numpy()
    a = sp.csr_matrix((np.ones(len(gr.in_colidx)), gr.in_colidx,
                       gr.in_rowptr), shape=(gr.m, gr.m))
    want = a[sh.lo:sh.hi] @ r.from_padded(x.cpu().numpy()).astype(np.float64)
    n = sh.hi - sh.lo
    err = float(np.abs(y[:n] - want).max()) if n else 0.0
    rel = err / max(1e-30, float(np.abs(want).max())) if n else 0.0
    pad = float(np.abs(y[n:]).max()) if len(y) > n else 0.0
    return {"rows": n, "rows_per_shard": r.rows_per_shard,
            "columns": r.padded_size(), "max_abs_err": err,
            "max_rel_err": rel, "pad_rows_max": pad,
            "ok": bool(y.shape == (r.rows_per_shard,) and pad == 0
                       and np.isfinite(rel) and rel < SHARD_REL_LIMIT)}


def record_min_kernels(run):
    """(run()'s result, {"k2": stats, "m1": stats}, the operand of M1's
    call with the most entries under the sentinel, or None): every call
    of K2 (minselect.dense_panel_minselect) and M1 (dense_panel_minplus)
    in the run is held, as it returns, to its plain version on the same
    panel array, block table and operand, exactly; stats count the calls,
    the rows and the rows that differ, and the worst |diff|."""
    import torch
    from gardenia_tpu_torch.ops import minselect
    keep = (minselect.dense_panel_minselect, minselect.dense_panel_minplus)
    stats = {k: {"calls": 0, "rows": 0, "mismatches": 0, "max_abs_err": 0}
             for k in ("k2", "m1")}
    operand = {"x2d": None, "live": -1}

    def hold(name, y_k, y_p):
        st = stats[name]
        if y_k.shape != y_p.shape or y_k.dtype != torch.int32:
            st["mismatches"] += max(1, y_p.numel())
            return
        diff = (y_k.long() - y_p.long()).abs()
        st["calls"] += 1
        st["rows"] += y_k.numel()
        st["mismatches"] += int((diff != 0).sum())
        st["max_abs_err"] = max(st["max_abs_err"], int(diff.max())
                                if diff.numel() else 0)

    def k2(panel, src, x2d, sentinel):
        y = keep[0](panel, src, x2d, sentinel)
        hold("k2", y, minselect.dense_panel_minselect_plain(panel, src, x2d,
                                                            sentinel))
        return y

    def m1(panel, src, x2d, sentinel, scale=1):
        y = keep[1](panel, src, x2d, sentinel, scale)
        hold("m1", y, minselect.dense_panel_minplus_plain(panel, src, x2d,
                                                          sentinel, scale))
        live = int((x2d < sentinel).sum())
        if live > operand["live"]:
            operand.update(x2d=x2d.clone(), live=live)
        return y

    minselect.dense_panel_minselect, minselect.dense_panel_minplus = k2, m1
    try:
        res = run()
    finally:
        minselect.dense_panel_minselect, minselect.dense_panel_minplus = keep
    return res, stats, operand["x2d"]


def time_m1(sh, x2d) -> dict:
    """M1 alone over every panel array of a rank's shard with the operand
    x2d, by CUDA events, in turns with its plain version; K2 on the same
    panels and labels beside it; the sweep's bytes and its bound."""
    from gardenia_tpu_torch.core import types as T
    from gardenia_tpu_torch.ops import minselect
    inf, scale = int(T.MYINFINITY), int(sh.mat.scale)

    def sweep(fn, *extra):
        return lambda: [fn(p.panel, p.src, x2d, inf, *extra)
                        for p in sh.mat.dense]
    t = {"m1": [], "plain": [], "k2": []}
    for which in ("plain", "m1", "m1", "plain"):
        if which == "m1":
            t["m1"].append(cuda_ms(sweep(minselect.dense_panel_minplus,
                                         scale), reps=10, warmup=1))
            t["k2"].append(cuda_ms(sweep(minselect.dense_panel_minselect),
                                   reps=10, warmup=1))
        else:
            t["plain"].append(cuda_ms(sweep(
                minselect.dense_panel_minplus_plain, scale), reps=1,
                warmup=1))
    nbytes, cells, nz = panel_work(sh.mat, x2d.numel() * 4)
    # a compare a cell; an add and a min a nonzero cell
    b_ms, b_by = bound(nbytes, cells + 2 * nz)
    return {"ms": sum(t["m1"]) / 2, "plain_ms": sum(t["plain"]) / 2,
            "k2_ms_same_panels": sum(t["k2"]) / 2, "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nbytes, "cells": cells,
            "nonzero_cells": nz, "arrays": len(sh.mat.dense),
            "runs": {k: [round(v, 4) for v in vs] for k, vs in t.items()}}


def m1_hand_cases(dev) -> dict:
    """M1 against its plain version on hand-made panels, exactly: each
    panel dtype at W = 1, 4 and 32 (one 16-byte chunk a lane and row
    groups of 8, 16 and 32 lanes), scale 1 and 3, sparse cells of random
    weights with some at the widest weight the dtype holds (M1_TOP_WEIGHTS)
    and, in bf16 and f32, some -0.0 cells (no edge); rows with no cell
    (the sentinel); a slot whose every cell is an edge and whose operand
    is all sentinel (the sum passes it: clamped); an operand a third
    sentinel."""
    import torch
    from gardenia_tpu_torch.core import types as T
    from gardenia_tpu_torch.ops import minselect
    inf = int(T.MYINFINITY)
    dtypes = {0: torch.int8, 1: torch.bfloat16, 2: torch.float32}
    rng = np.random.default_rng(24)
    st = {"cases": 0, "rows": 0, "mismatches": 0, "max_abs_err": 0}
    qx = 40
    x = rng.integers(0, 1 << 20, qx * 128).astype(np.int32)
    x[rng.random(qx * 128) < 0.33] = inf
    x[-128:] = inf                            # the last block: all sentinel
    x2d = torch.from_numpy(x.reshape(qx, 128)).to(dev)
    for code, top in M1_TOP_WEIGHTS:
        for W in (1, 4, 32):
            R = 9
            cells = np.zeros((R, 128, W * 128), np.float32)
            hit = rng.random(cells.shape) < 0.04
            cells[hit] = rng.integers(1, min(top, 100) + 1, int(hit.sum()))
            cells[hit & (rng.random(cells.shape) < 0.1)] = top
            cells[:, ::7] = 0                 # rows with no neighbour
            cells[R - 1] = top                # a slot of edges only ...
            src = rng.integers(0, qx - 1, (R, W)).astype(np.int32)
            src[R - 1] = qx - 1               # ... on an all-sentinel block
            panel = torch.from_numpy(cells).to(dtypes[code])
            if code:
                zero = torch.from_numpy(~hit & (rng.random(cells.shape)
                                                < 0.01))
                panel[zero] = -0.0
            panel, src_t = panel.to(dev), torch.from_numpy(src).to(dev)
            for scale in (1, 3):
                y_k = minselect.dense_panel_minplus(panel, src_t, x2d, inf,
                                                    scale)
                y_p = minselect.dense_panel_minplus_plain(panel, src_t, x2d,
                                                          inf, scale)
                diff = (y_k.long() - y_p.long()).abs()
                st["cases"] += 1
                st["rows"] += y_k.numel()
                st["mismatches"] += int((diff != 0).sum())
                st["max_abs_err"] = max(st["max_abs_err"], int(diff.max()))
                if not (y_p[:, ::7] == inf).all() or \
                        not (y_p[R - 1] == inf).all():
                    fail(f"M1's plain version: rows without a candidate "
                         f"under the sentinel are not the sentinel "
                         f"({dtypes[code]}, W={W}, scale {scale})")
    return st


def dist_rank(mesh, graphs: dict, cases):
    """Phases 23 and 24 on one rank: for each case (kernel, graph name,
    args, kwargs), the dist solver of gardenia_tpu_torch.parallel on that
    graph, twice: the first solve builds the rank's shard, with K1's calls
    recorded and every K2 and M1 call held to its plain version as it
    returns (record_min_kernels); the second runs with K1's, K2's and M1's
    launch counts and the mesh's collective counts set to 0 just before
    and read just after, timed by the host clock between synchronizes;
    then its collectives replayed alone, and K1's recorded calls held
    against the plain version (hold_k1_calls) and, on the hybrid PR and
    BFS shards, the whole shard's apply against scipy (hold_shard_apply).
    On one rank, M1 is timed alone on the SSSP shard (time_m1).  A case's
    result comes back from rank 0 (all ranks hold it)."""
    import torch
    from gardenia_tpu_torch import parallel
    from gardenia_tpu_torch.core.relabel import relabeled
    from gardenia_tpu_torch.ops import minselect, panel
    from gardenia_tpu_torch.parallel.pr import shard_of
    solvers = {"pr": parallel.pr_solver_dist, "bfs": parallel.bfs_solver_dist,
               "msbfs": parallel.bfs_multi_source_dist,
               "tc": parallel.tc_solver_dist, "vc": parallel.vc_solver_dist,
               "scc": parallel.scc_solver_dist,
               "cc": parallel.cc_solver_dist,
               "sssp": parallel.sssp_solver_dist,
               "spmv": parallel.spmv_solver_dist,
               "symgs": parallel.symgs_solver_dist,
               "bc": parallel.bc_batched_dist,
               "mst": parallel.mst_solver_dist,
               "sgd": parallel.sgd_train_dist,
               "tc2d": parallel.tc_solver_dist2d,
               "scc2d": parallel.scc_solver_dist2d,
               "vc2d": parallel.vc_solver_dist2d}
    outs = []
    for kernel, name, args, kwargs in cases:
        g, solve = graphs[name], solvers[kernel]
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        (_, k1_rec), mins, x2d = record_min_kernels(lambda: record_k1(
            lambda: solve(g, *args, mesh=mesh, **kwargs)))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        panel.LAUNCHES.update(simt=0, tc=0)
        minselect.LAUNCHES = minselect.MINPLUS_LAUNCHES = 0
        mesh.calls = dict.fromkeys(mesh.calls, 0)
        mesh.bytes = dict.fromkeys(mesh.bytes, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve(g, *args, mesh=mesh, **kwargs)
        torch.cuda.synchronize()
        out = {"ms": (time.perf_counter() - t0) * 1e3, "first_s": first_s,
               "launches": dict(panel.LAUNCHES),
               "k2_launches": minselect.LAUNCHES,
               "m1_launches": minselect.MINPLUS_LAUNCHES,
               "calls": dict(mesh.calls),
               "bytes": dict(mesh.bytes), "mesh": mesh.describe(),
               "result": res if mesh.rank == 0 else None,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        out["replay_ms"] = replay_collectives(mesh, out["calls"],
                                              out["bytes"])
        if k1_rec is not None:
            out["k1_hold"] = hold_k1_calls(k1_rec)
        for k in ("k2", "m1"):
            if mins[k]["calls"]:
                out[f"{k}_hold"] = mins[k]
        hybrid = kwargs.get("layout", "hybrid") == "hybrid"
        if kernel in ("pr", "bfs", "cc", "sssp") and hybrid:
            gr = relabeled(g).graph
            sh = shard_of(gr, mesh, "hybrid", "edges",
                          reverse=kernel != "cc",
                          weighted=kernel == "sssp" and
                          gr.weights is not None)
            out["arrays"] = len(sh.mat.dense)
            if kernel in ("pr", "bfs") and k1_rec is not None:
                out["shard_hold"] = hold_shard_apply(gr, sh, k1_rec["x3d"])
            if kernel == "sssp" and mesh.size == 1 and x2d is not None:
                out["m1_time"] = time_m1(sh, x2d)
        del k1_rec, x2d
        outs.append(out)
    return outs


def dist_phase(dev, gpu: str, g, g16) -> tuple:
    """Phase 23: the port's multi-device path on the card.  One rank
    (nccl): pr_solver_dist on R-MAT-20 (hybrid layout, K1 on the rank's
    shard) against the single-device pr_solver.  Two ranks on the one card
    (gloo with CUDA tensors): PR at R-MAT-20; BFS (hybrid and ell) from
    the vertex of highest degree, MS-BFS-dp with 128 sources, TC, VC and
    SCC (directed) at R-MAT-16, each against its reference.  Then the CLI
    (pr rmat 16 --dist=2), the entry twin and dryrun_multichip(2), and the
    bench's --quick.  Returns K1's launches by dist path, and by path the
    worst errors of K1's calls on the ranks' shards against the plain
    version (and of the PR and BFS shards' whole apply against scipy)."""
    import torch
    import scipy.sparse.csgraph as csg
    from gardenia_tpu_torch import bench
    from gardenia_tpu_torch.cli import same_components
    from gardenia_tpu_torch.core.graph import from_csr_of
    from gardenia_tpu_torch.entry import dryrun_multichip, entry
    from gardenia_tpu_torch.parallel import run_on_ranks
    from gardenia_tpu_torch.solvers.pr import EPSILON, pr_solver
    from gardenia_tpu_torch.solvers.tc import tc_solver
    from gardenia_tpu_torch.utils.timer import time_op
    from gardenia_tpu_torch.verify import oracles
    t_phase = time.perf_counter()
    single, single_s = time_op(lambda: pr_solver(g, device=dev), device=dev)
    want = single.scores.cpu().numpy()
    k1, holds = {}, {}

    def report(label, ranks, per_iter, extra="", phase=23):
        r0 = ranks[0]
        iters = max(1, per_iter)
        holds = [{k: r[k] for k in ("k1_hold", "shard_hold") if k in r}
                 for r in ranks]
        if any(holds):
            extra += f"; holds by rank {json.dumps(holds)}"
        print(f"[{phase}] {label}: {r0['mesh']}; solve {r0['ms']:.3f} ms (first "
              f"{r0['first_s']:.1f} s with the shard's build); collectives "
              f"a rank {json.dumps(r0['calls'])}, "
              f"{sum(r0['bytes'].values()) / iters / 1e6:.3f} MB and "
              f"{r0['replay_ms'] / iters:.3f} ms replayed alone an "
              f"iteration ({iters}); K1 launches by rank "
              f"{json.dumps([r['launches'] for r in ranks])}; peak device "
              f"memory {max(r['peak_gib'] for r in ranks):.2f} GiB; "
              f"gpu: {gpu}" + extra)

    def hold_ranks(label, ranks, shard):
        """Fail unless every rank held K1's recorded calls to the plain
        version (and, with shard, its whole shard's apply to scipy)."""
        for r in ranks:
            h = r.get("k1_hold")
            if h is None or not h["arrays"] or h["mismatches"]:
                fail(f"{label}: K1 on a rank's shard disagrees with its "
                     f"plain version or was not held: {h}")
            if shard and not r.get("shard_hold", {}).get("ok"):
                fail(f"{label}: a rank's shard apply disagrees with scipy: "
                     f"{r.get('shard_hold')}")
        holds[label] = {k: max(r[h][k] for r in ranks if h in r)
                        for h in ("k1_hold",)
                        for k in ("max_abs_err", "max_rel_err")}
        if shard:
            holds[label]["shard_max_rel_err"] = max(
                r["shard_hold"]["max_rel_err"] for r in ranks)

    # ---- one rank (nccl) on R-MAT-20; two (gloo) on R-MAT-20 and 16 -----
    # [23]'s cases and [24]'s run in the same two groups: the ranks
    # relabel R-MAT-20 once, and its CC and SSSP shards are PR's
    src = int(np.argmax(g16.degrees))
    src20 = int(np.argmax(g.degrees))
    sources = np.arange(bench.SOURCES)
    gd16 = bench.get_graph_directed(SMOKE_SCALE)
    cases = {f"pr dist2 rmat{MAIN_SCALE}": ("pr", "g", (), {}),
             f"bfs hybrid dist2 rmat{SMOKE_SCALE} from {src}":
             ("bfs", "g16", (src,), {}),
             f"bfs ell dist2 rmat{SMOKE_SCALE} from {src}":
             ("bfs", "g16", (src,), {"layout": "ell"}),
             f"msbfs dist2 rmat{SMOKE_SCALE}, {len(sources)} sources":
             ("msbfs", "g16", (sources,), {}),
             f"tc dist2 rmat{SMOKE_SCALE}": ("tc", "g16", (), {}),
             f"vc dist2 rmat{SMOKE_SCALE}": ("vc", "g16", (), {}),
             f"scc dist2 rmat{SMOKE_SCALE}d": ("scc", "gd16", (), {})}
    rng = np.random.default_rng(24)
    spmv_in = (rng.random(g16.nnz).astype(np.float32),
               rng.random(g16.n).astype(np.float32))
    from gardenia_tpu_torch.solvers.vc import vc_solver
    symgs_in = (rng.random(g16.nnz).astype(np.float32),
                rng.random(g16.m).astype(np.float32),
                rng.random(g16.m).astype(np.float32),
                (g16.degrees + 1).astype(np.float32),
                vc_solver(g16, device=dev).colors.cpu().numpy())
    big = {f"cc hybrid dist{n} rmat{MAIN_SCALE}": ("cc", "g", (), {})
           for n in (1, 2)}
    big.update({f"sssp hybrid dist{n} rmat{MAIN_SCALE} from {src20}":
                ("sssp", "g", (src20,), {}) for n in (1, 2)})
    cases24 = {
        **{k: v for k, v in big.items() if "dist2" in k},
        f"cc ell dist2 rmat{SMOKE_SCALE}": ("cc", "g16", (),
                                            {"layout": "ell"}),
        f"sssp ell dist2 rmat{SMOKE_SCALE}w from {src}":
        ("sssp", "g16w", (src,), {"layout": "ell"}),
        f"sssp hybrid dist2 rmat{SMOKE_SCALE}w from {src}":
        ("sssp", "g16w", (src,), {}),
        f"spmv dist2 rmat{SMOKE_SCALE}": ("spmv", "g16", spmv_in, {}),
        f"bc dist2 rmat{SMOKE_SCALE}, {len(sources)} sources":
        ("bc", "g16", (sources,), {"layout": "hybrid"}),
        f"symgs dist2 rmat{SMOKE_SCALE}": ("symgs", "g16", symgs_in, {}),
        f"sgd dist2 rmat{SMOKE_SCALE}, {DIST_SGD_ITERS} iterations":
        ("sgd", "g16r", (), {"iters": DIST_SGD_ITERS,
                             "step": DIST_SGD_STEP}),
        f"mst dist2 rmat{SMOKE_SCALE}w": ("mst", "g16w", (), {}),
        f"tc2d dist2 rmat{SMOKE_SCALE}": ("tc2d", "g16", (), {}),
        f"scc2d dist2 rmat{SMOKE_SCALE}d": ("scc2d", "gd16", (), {}),
        f"vc2d dist2 rmat{SMOKE_SCALE}": ("vc2d", "g16", (), {})}
    one_cases = {f"pr dist1 rmat{MAIN_SCALE}":
                 cases[f"pr dist2 rmat{MAIN_SCALE}"],
                 **{k: v for k, v in big.items() if "dist1" in k}}
    graphs = {"g": from_csr_of(g), "g16": from_csr_of(g16),
              "gd16": from_csr_of(gd16),
              "g16w": from_csr_of(bench.mst_graph(g16)),
              "g16r": from_csr_of(bench.sgd_graph(g16))}
    t0 = time.perf_counter()
    one = run_on_ranks(dist_rank, 1, "cuda", {"g": graphs["g"]},
                       list(one_cases.values()))
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    two = run_on_ranks(dist_rank, 2, "cuda", graphs,
                       list(cases.values()) + list(cases24.values()))
    print(f"[23] runs: one rank {t_one:.1f} s, two ranks "
          f"{time.perf_counter() - t0:.1f} s (spawn, the graphs to the ranks, "
          f"each rank's relabelling and shards, two solves a case; [24]'s "
          f"cases among them)")
    got = {label: [one[0][i]] for i, label in enumerate(one_cases)}
    got.update({label: [r[i] for r in two]
                for i, label in enumerate([*cases, *cases24])})

    for n in (1, 2):
        label = f"pr dist{n} rmat{MAIN_SCALE}"
        ranks = got[label]
        res = ranks[0]["result"]
        scores = res.scores.numpy()
        diff = float(np.abs(scores - want).max())
        rel = diff / float(np.abs(want).max())
        resid = oracles.pagerank_push_residual(g, scores)
        report(label, ranks, res.iterations,
               f"; {res.iterations} iterations (pr_solver {single.iterations}"
               f"), max|diff| vs pr_solver {diff:.3e} (rel {rel:.3e}), "
               f"residual {resid:.3e}; pr_solver's solve "
               f"{single_s * 1e3:.3f} ms")
        if res.iterations != single.iterations or not diff < 1e-6 or \
                not rel < DIST_PR_REL_LIMIT or not resid < EPSILON:
            fail(f"pr_solver_dist on {n} rank(s) disagrees with pr_solver")
        hold_ranks(label, ranks, shard=True)
        for r in ranks:
            if r["launches"]["simt"] != res.iterations * r["arrays"] or \
                    not r["launches"]["simt"]:
                fail(f"K1 launches {r['launches']} on a rank of {label} != "
                     f"{res.iterations} x {r['arrays']} arrays")
        k1[label] = {"simt": sum(r["launches"]["simt"] for r in ranks)}

    bfs_want = oracles.bfs_serial(g16, src)
    for layout in ("hybrid", "ell"):
        label = f"bfs {layout} dist2 rmat{SMOKE_SCALE} from {src}"
        ranks = got[label]
        res = ranks[0]["result"]
        ok = bool((res.dist.numpy() == bfs_want).all())
        report(label, ranks, res.iterations, f"; {res.iterations} levels, "
               f"depths {'equal' if ok else 'NOT equal'} to "
               f"oracles.bfs_serial")
        if not ok:
            fail(f"bfs_solver_dist ({layout}) disagrees with the oracle")
        if layout == "hybrid":
            if not all(r["launches"]["simt"] for r in ranks):
                fail("a rank of bfs dist2 launched no K1")
            hold_ranks(label, ranks, shard=True)
            k1[f"bfs dist2 rmat{SMOKE_SCALE}"] = {
                "simt": sum(r["launches"]["simt"] for r in ranks)}
    label = f"msbfs dist2 rmat{SMOKE_SCALE}, {len(sources)} sources"
    ranks = got[label]
    res = ranks[0]["result"]
    bad = int((res.dist.numpy() != bfs_depths_bits(g16, sources))
              .any(axis=0).sum())
    report(label, ranks, 1, f"; {res.iterations} levels, {bad} of "
           f"{len(sources)} columns differ from the numpy bitset BFS")
    if bad or tuple(res.dist.shape) != (g16.m, len(sources)):
        fail("bfs_multi_source_dist disagrees with the bitset BFS")
    if not all(r["launches"]["tc"] for r in ranks):
        fail("a rank of msbfs dist2 launched no K1 tensor-core kernel")
    hold_ranks(label, ranks, shard=False)
    k1[f"msbfs dist2 rmat{SMOKE_SCALE}"] = {
        "tc": sum(r["launches"]["tc"] for r in ranks)}
    label = f"tc dist2 rmat{SMOKE_SCALE}"
    ranks = got[label]
    want_tc = tc_solver(g16, device=dev)
    report(label, ranks, 1, f"; {ranks[0]['result']} triangles (tc_solver "
           f"{want_tc})")
    if ranks[0]["result"] != want_tc:
        fail("tc_solver_dist disagrees with tc_solver")
    label = f"vc dist2 rmat{SMOKE_SCALE}"
    ranks = got[label]
    res = ranks[0]["result"]
    ok = oracles.vc_check(g16, res.colors.numpy())
    report(label, ranks, res.iterations, f"; {res.num_colors} colours in "
           f"{res.iterations} rounds: {'proper' if ok else 'NOT proper'}")
    if not ok:
        fail("vc_solver_dist's colouring is not proper")
    label = f"scc dist2 rmat{SMOKE_SCALE}d"
    ranks = got[label]
    root = ranks[0]["result"].scc_root.numpy()
    _, want_scc = csg.connected_components(scipy_csr(gd16), directed=True,
                                           connection="strong")
    ok = same_components(root, want_scc)
    report(label, ranks, ranks[0]["result"].iterations,
           f"; {len(np.unique(root))} SCCs, scipy's {want_scc.max() + 1}: "
           f"{'a bijection' if ok else 'NOT a bijection'}")
    if not ok:
        fail("scc_solver_dist disagrees with scipy's strong components")

    # ---- the CLI, the entry twin, dryrun_multichip, bench --quick --------
    for cmd in (["-m", "gardenia_tpu_torch.cli", "pr", "rmat",
                 str(SMOKE_SCALE), "--dist=2"],
                ["-m", "gardenia_tpu_torch.bench", "--quick"]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *cmd], capture_output=True,
                              text=True, timeout=600)
        lines = proc.stdout.splitlines()
        print(f"[23] {' '.join(cmd[1:])} ({time.perf_counter() - t0:.1f} s):"
              f" " + " | ".join(ln.strip() for ln in lines[-4:]))
        if proc.returncode != 0 or not lines:
            fail(f"{' '.join(cmd)} exited {proc.returncode}: {proc.stderr}")
        if cmd[1].endswith("cli") and lines[-1] != "Correct":
            fail("the CLI's pr --dist=2 did not end Correct")
    if not lines[-1].startswith("{") or json.loads(lines[-1])["metric"] != \
            f"pr_pull_gteps_rmat{SMOKE_SCALE}":
        fail("bench --quick printed no JSON line of scale 16")
    step, (x0,) = entry(device="cuda")
    step_c, (x0_c,) = entry(device="cpu")
    diff = float((step(x0).cpu() - step_c(x0_c)).abs().max())
    print(f"[23] entry(): pr_step on the card vs on CPU tensors (the plain "
          f"K1): max|diff| {diff:.3e}")
    if not diff < 1e-6:
        fail("entry()'s step on the card differs from the plain one")
    print(f"[23] phase time {time.perf_counter() - t_phase:.1f} s")
    clock(24)
    p24 = dist_rest(dev, gpu, g, g16, gd16, graphs, got, cases24, src, src20,
                    spmv_in, symgs_in, want_tc, want_scc, report, hold_ranks,
                    k1)
    return k1, holds, p24


def dist_rest(dev, gpu: str, g, g16, gd16, graphs, got, cases24, src: int,
              src20: int, spmv_in, symgs_in, want_tc: int, want_scc,
              report, hold_ranks, k1: dict) -> dict:
    """Phase 24: the rest of the multi-device layer, from [23]'s groups.
    At R-MAT-20 on one rank (nccl) and two (gloo): cc_solver_dist hybrid
    against scipy's components (a bijection), K2 on each rank's shard
    every round; sssp_solver_dist hybrid, unweighted, from the vertex of
    highest degree against scipy's BFS depths, M1 every round, and M1 timed
    alone on the one-rank shard beside its plain version, K2 on the same
    panels and its bound.  At R-MAT-16 on two ranks: CC ell; SSSP ell and
    hybrid on the MST bench's hashed weights against scipy's Dijkstra;
    SpMV against scipy's f64 product; BC hybrid (128 sources) against
    bc_batched; SymGS against symgs_solver on the same inputs; SGD's
    full-batch steps against an f64 numpy replica; MST against scipy's
    tree weight; the 1x2 mesh's TC, SCC and VC against tc_solver, scipy's
    SCCs and vc_check.  Every K2 and M1 call of the cases' first solves
    held exactly to its plain version; K2's and M1's launches of the
    second solves = rounds x the rank's panel arrays; M1's hand cases;
    dryrun_multichip(2) with all 13 kernels.  Returns K2's and M1's
    launches by path, their holds and M1's timing."""
    import scipy.sparse.csgraph as csg
    from gardenia_tpu_torch.cli import same_components
    from gardenia_tpu_torch.core import types as T
    from gardenia_tpu_torch.entry import dryrun_multichip
    from gardenia_tpu_torch.solvers.bc import bc_batched
    from gardenia_tpu_torch.solvers.symgs import symgs_solver
    from gardenia_tpu_torch.verify import oracles
    t_phase = time.perf_counter()
    report = functools.partial(report, phase=24)
    inf = int(T.MYINFINITY)
    out = {"k2_paths": {}, "m1_paths": {}, "k2_holds": {}, "m1_holds": {},
           "m1_time": None}
    share = sum(r["first_s"] + r["ms"] / 1e3 for label in cases24
                for r in got[label][:1])
    share += sum(got[label][0]["first_s"] + got[label][0]["ms"] / 1e3
                 for label in got if "dist1" in label and
                 not label.startswith("pr"))

    def kernel_holds(label, ranks, key, launches_key, rounds, paths, hold):
        """Fail unless every rank's K2 or M1 calls held exactly and each
        launched rounds x its arrays in the timed solve."""
        for r in ranks:
            h = r.get(key)
            if h is None or not h["calls"] or h["mismatches"]:
                fail(f"{label}: {key[:2].upper()} on a rank's shard "
                     f"disagrees with its plain version or was not held: "
                     f"{h}")
            if r[launches_key] != rounds * r["arrays"] or \
                    not r[launches_key]:
                fail(f"{label}: {r[launches_key]} launches on a rank != "
                     f"{rounds} rounds x {r['arrays']} arrays")
        paths[label] = sum(r[launches_key] for r in ranks)
        hold[label] = {"calls": sum(r[key]["calls"] for r in ranks),
                       "rows": sum(r[key]["rows"] for r in ranks),
                       "mismatches": 0}

    # ---- R-MAT-20: CC and SSSP hybrid on one and two ranks --------------
    t0 = time.perf_counter()
    _, comp20 = csg.connected_components(scipy_csr(g), directed=False)
    depth20 = bfs_depths_scipy(g, [src20])[:, 0]
    print(f"[24] scipy's R-MAT-{MAIN_SCALE} components and BFS depths from "
          f"{src20}: {time.perf_counter() - t0:.1f} s")
    for n in (1, 2):
        label = f"cc hybrid dist{n} rmat{MAIN_SCALE}"
        ranks = got[label]
        res = ranks[0]["result"]
        ok = same_components(res.comp.numpy(), comp20)
        report(label, ranks, res.iterations,
               f"; {res.iterations} rounds, {len(np.unique(res.comp))} "
               f"components: {'a bijection' if ok else 'NOT a bijection'} "
               f"of scipy's; K2 launches by rank "
               f"{[r['k2_launches'] for r in ranks]}, arrays "
               f"{[r['arrays'] for r in ranks]}")
        if not ok:
            fail(f"{label} disagrees with scipy's components")
        kernel_holds(label, ranks, "k2_hold", "k2_launches", res.iterations,
                     out["k2_paths"], out["k2_holds"])
        label = f"sssp hybrid dist{n} rmat{MAIN_SCALE} from {src20}"
        ranks = got[label]
        res = ranks[0]["result"]
        ok = bool((res.dist.numpy() == depth20).all())
        report(label, ranks, res.iterations,
               f"; {res.iterations} rounds, distances "
               f"{'equal' if ok else 'NOT equal'} to scipy's BFS depths; M1 "
               f"launches by rank {[r['m1_launches'] for r in ranks]}")
        if not ok:
            fail(f"{label} disagrees with scipy's BFS depths")
        kernel_holds(label, ranks, "m1_hold", "m1_launches", res.iterations,
                     out["m1_paths"], out["m1_holds"])
        if n == 1:
            out["m1_time"] = tm = ranks[0]["m1_time"]
            print(f"[24] M1 alone on the one-rank R-MAT-{MAIN_SCALE} shard "
                  f"({tm['arrays']} panel arrays, {tm['nonzero_cells']} "
                  f"nonzero of {tm['cells']} cells): {tm['ms']:.3f} ms, "
                  f"plain {tm['plain_ms']:.3f} ms, K2 on the same panels "
                  f"{tm['k2_ms_same_panels']:.3f} ms; {tm['bytes'] / 1e9:.3f}"
                  f" GB once -> {tm['bytes'] / tm['ms'] / 1e6:.0f} GB/s, "
                  f"bound {tm['bound_ms']:.3f} ms ({tm['bound_by']}); runs "
                  f"{json.dumps(tm['runs'])}; gpu: {gpu}")

    # ---- R-MAT-16 on two ranks -----------------------------------------
    g16w = graphs["g16w"]
    wi = np.asarray(g16w.weights, np.float64)
    dij = csg.dijkstra(scipy_csr(g16w, wi), directed=True, indices=src)
    dij = np.where(np.isfinite(dij), dij, inf)
    label = f"cc ell dist2 rmat{SMOKE_SCALE}"
    ranks = got[label]
    res = ranks[0]["result"]
    _, comp16 = csg.connected_components(scipy_csr(g16), directed=False)
    ok = same_components(res.comp.numpy(), comp16)
    report(label, ranks, res.iterations, f"; {res.iterations} rounds: "
           f"{'a bijection' if ok else 'NOT a bijection'} of scipy's")
    if not ok:
        fail(f"{label} disagrees with scipy's components")
    for layout in ("ell", "hybrid"):
        label = f"sssp {layout} dist2 rmat{SMOKE_SCALE}w from {src}"
        ranks = got[label]
        res = ranks[0]["result"]
        ok = bool((res.dist.numpy() == dij).all())
        report(label, ranks, res.iterations, f"; {res.iterations} rounds, "
               f"distances {'equal' if ok else 'NOT equal'} to scipy's "
               f"Dijkstra")
        if not ok:
            fail(f"{label} disagrees with scipy's Dijkstra")
        if layout == "hybrid":
            kernel_holds(label, ranks, "m1_hold", "m1_launches",
                         res.iterations, out["m1_paths"], out["m1_holds"])
    label = f"spmv dist2 rmat{SMOKE_SCALE}"
    ranks = got[label]
    ax, x = spmv_in
    want = scipy_csr(g16, ax.astype(np.float64)) @ x.astype(np.float64)
    y = ranks[0]["result"].numpy()
    rel = float(np.abs(y - want).max() / np.abs(want).max())
    ok = bool(np.allclose(y, want, rtol=2e-5, atol=1e-6))
    report(label, ranks, 1, f"; max|diff| / max|y| vs scipy's f64 product "
           f"{rel:.3e}: {'within' if ok else 'NOT within'} rtol 2e-5, "
           f"atol 1e-6")
    if not ok:
        fail(f"{label} disagrees with scipy's product")
    hold_ranks(label, ranks, shard=False)
    k1[label] = {"simt": sum(r["launches"]["simt"] for r in ranks)}
    label = next(k for k in cases24 if k.startswith("bc "))
    ranks = got[label]
    res = ranks[0]["result"]
    want = bc_batched(g16, cases24[label][2][0], device=dev).scores.cpu() \
        .numpy()
    err = float(np.abs(res.scores.numpy() - want).max())
    report(label, ranks, res.iterations, f"; {res.iterations} levels, "
           f"max|diff| vs bc_batched {err:.3e} (limit 1e-5)")
    if not err < 1e-5:
        fail(f"{label} disagrees with bc_batched")
    hold_ranks(label, ranks, shard=False)
    k1[label] = {"tc": sum(r["launches"]["tc"] for r in ranks)}
    label = f"symgs dist2 rmat{SMOKE_SCALE}"
    ranks = got[label]
    res = ranks[0]["result"]
    want = symgs_solver(g16, *symgs_in, device=dev).x.cpu().numpy()
    ok = bool(np.allclose(res.x.numpy(), want, rtol=1e-4, atol=1e-5))
    report(label, ranks, 2 * res.num_colors, f"; {res.num_colors} colours,"
           f" max|diff| vs symgs_solver "
           f"{float(np.abs(res.x.numpy() - want).max()):.3e}: "
           f"{'within' if ok else 'NOT within'} rtol 1e-4, atol 1e-5")
    if not ok:
        fail(f"{label} disagrees with symgs_solver")
    hold_ranks(label, ranks, shard=False)
    k1[label] = {"simt": sum(r["launches"]["simt"] for r in ranks)}
    label = f"sgd dist2 rmat{SMOKE_SCALE}, {DIST_SGD_ITERS} iterations"
    ranks = got[label]
    res = ranks[0]["result"]
    t0 = time.perf_counter()
    rmse, U, It = sgd_full_batch(graphs["g16r"], DIST_SGD_ITERS,
                                 DIST_SGD_STEP)
    rel_t = abs(float(res.rmse) - rmse) / rmse
    rel_f = max(float(np.abs(res.user_lv.numpy() - U).max() /
                      np.abs(U).max()),
                float(np.abs(res.item_lv.numpy() - It).max() /
                      np.abs(It).max()))
    report(label, ranks, DIST_SGD_ITERS, f"; rmse {float(res.rmse):.6f}, "
           f"the f64 replica's {rmse:.6f} ({time.perf_counter() - t0:.1f} s):"
           f" rel diff {rel_t:.3e} (limit {SGD_TRACE_REL}), factors "
           f"{rel_f:.3e} (limit {SGD_FACTOR_REL})")
    if not (rel_t < SGD_TRACE_REL and rel_f < SGD_FACTOR_REL):
        fail(f"{label} disagrees with its f64 replica")
    label = f"mst dist2 rmat{SMOKE_SCALE}w"
    ranks = got[label]
    res = ranks[0]["result"]
    want = float(csg.minimum_spanning_tree(scipy_csr(g16w, wi)).sum())
    report(label, ranks, 1, f"; weight {res.total_weight}, scipy's "
           f"{want}: {'equal' if res.total_weight == want else 'NOT equal'}")
    if res.total_weight != want:
        fail(f"{label}'s weight differs from scipy's")
    label = f"tc2d dist2 rmat{SMOKE_SCALE}"
    ranks = got[label]
    report(label, ranks, 1, f"; {ranks[0]['result']} triangles (tc_solver "
           f"{want_tc})")
    if ranks[0]["result"] != want_tc:
        fail(f"{label} disagrees with tc_solver")
    label = f"scc2d dist2 rmat{SMOKE_SCALE}d"
    ranks = got[label]
    res = ranks[0]["result"]
    ok = same_components(res.scc_root.numpy(), want_scc)
    report(label, ranks, res.iterations, f"; {res.iterations} rounds: "
           f"{'a bijection' if ok else 'NOT a bijection'} of scipy's SCCs")
    if not ok:
        fail(f"{label} disagrees with scipy's strong components")
    label = f"vc2d dist2 rmat{SMOKE_SCALE}"
    ranks = got[label]
    res = ranks[0]["result"]
    ok = oracles.vc_check(g16, res.colors.numpy())
    report(label, ranks, res.iterations, f"; {res.num_colors} colours in "
           f"{res.iterations} rounds: {'proper' if ok else 'NOT proper'}")
    if not ok:
        fail(f"{label}'s colouring is not proper")

    # ---- M1's hand cases, the 13-kernel dryrun ---------------------------
    out["m1_hand"] = hand = m1_hand_cases(dev)
    print(f"[24] M1 hand cases (int8/bf16/f32 panels, W 1/4/32, scale 1 and"
          f" 3, the widest weights, -0.0 cells, rows with no edge, a slot "
          f"past the sentinel): {json.dumps(hand)}")
    if hand["mismatches"]:
        fail(f"M1 disagrees with its plain version on the hand cases")
    t0 = time.perf_counter()
    line = dryrun_multichip(2)               # prints its OK line or raises
    kernels = line.split("kernels ")[1].split(",")[0].split("+")
    print(f"[24] dryrun_multichip(2): {len(kernels)} kernels, "
          f"{time.perf_counter() - t0:.1f} s")
    if len(kernels) != 13:
        fail(f"dryrun_multichip ran {len(kernels)} kernels, not 13")
    print(f"[24] K2 launches by path {json.dumps(out['k2_paths'])}, M1 "
          f"{json.dumps(out['m1_paths'])}; gpu: {gpu}")
    print(f"[24] phase time {time.perf_counter() - t_phase:.1f} s, and "
          f"{share:.1f} s of [23]'s group runs (its cases' two solves)")
    return out


def sgd_full_batch(gr, iters: int, step: float):
    """(last rmse, user_lv, item_lv) of an independent float64 replica of
    sgd_train_dist's full-batch steps on the rating graph gr, from
    init_latent(m, 0), (n, 1): per-vertex sums as scipy.sparse products."""
    import scipy.sparse as sp
    from gardenia_tpu_torch.solvers.sgd import (DEFAULT_LAMBDA, init_latent,
                                                num_items)
    m, n, nnz = gr.m, num_items(gr), gr.nnz
    src = np.repeat(np.arange(m), np.diff(gr.rowptr))
    dst = np.asarray(gr.colidx, np.int64)
    r = np.asarray(gr.weights, np.float64)
    lam = float(np.float32(DEFAULT_LAMBDA))
    step = float(np.float32(step))
    U = init_latent(m, 0).astype(np.float64)
    It = init_latent(n, 1).astype(np.float64)
    e = np.arange(nnz)
    to_u = sp.csr_matrix((np.ones(nnz), (src, e)), shape=(m, nnz))
    to_i = sp.csr_matrix((np.ones(nnz), (dst, e)), shape=(n, nnz))
    rmse = 0.0
    for _ in range(iters):
        us, it_ = U[src], It[dst]
        delta = r - (us * it_).sum(1)
        rmse = float(np.sqrt((delta * delta).sum() / nnz))
        U, It = (U - step * (to_u @ (lam * us - delta[:, None] * it_)),
                 It - step * (to_i @ (lam * it_ - delta[:, None] * us)))
    return rmse, U, It


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
    from gardenia_tpu_torch.ops import _build, bsr, panel, spmv
    from gardenia_tpu_torch.bench import SOURCES
    from gardenia_tpu_torch.solvers.pr import EPSILON, pr_solver

    dev = gardenia_tpu_torch.resolve_device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False    # plain version in f32
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. environment ---------------------------------------------------
    clock(1)
    gpu = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    nvcc_release = [ln for ln in run([_build.find_nvcc(), "--version"])
                    .splitlines() if "release" in ln]
    print(gpu)                                   # nvidia-smi's own line
    print(f"[1] torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"device_count {torch.cuda.device_count()}")
    print(f"[1] nvcc: {nvcc_release[0].strip() if nvcc_release else '?'}")
    # the host, whose speed moves the host-bound bench entries
    print("[1] host: " + "; ".join(host_lines()))

    # ---- 2. build ---------------------------------------------------------
    clock(2)
    t0 = time.perf_counter()
    so = _build.build(force=True)
    _build.lib()
    print(f"[2] built {so} from {len(_build.sources())} source(s) in "
          f"{time.perf_counter() - t0:.1f} s")
    # the batched K1's resources: registers a thread at launch (setmaxnreg
    # then moves them: producer 56, consumers 224), spilled bytes, shared
    # memory a CTA, stages, CTAs an SM
    tc_info = {f"{str(pd)[6:]} panels, {str(xd)[6:]} operand":
               panel.tc_kernel_info(pd, xd)
               for pd in (torch.int8, torch.bfloat16)
               for xd in (torch.bfloat16, torch.float32)}
    print(f"[2] K1 tensor-core kernel: {json.dumps(tc_info)}")

    if "--dist-only" in sys.argv[1:]:
        # [23] and [24] alone, on their graphs, without the contract's
        # last lines: a quick first check of the multi-device path
        g16 = generate_graph("rmat", scale=SMOKE_SCALE, degree=16,
                             symmetrize=True)
        g = bench.get_graph(MAIN_SCALE)
        clock(23)
        _, _, p24 = dist_phase(dev, gpu, g, g16)
        print(json.dumps({k: p24[k] for k in ("k2_paths", "m1_paths",
                                              "m1_time", "m1_hand")}))
        print(f"[24] the run: {time.perf_counter() - RUN_START:.1f} s")
        return

    # ---- 3. K1 against its plain version, on the card ---------------------
    clock(3)
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
    clock(4)
    t0 = time.perf_counter()
    g = bench.get_graph(MAIN_SCALE)
    t_gen = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the layout "auto" takes on the card: relabel, build_ell, upload
    views.ell(views.relabel_maps(g, dev)[0], dev, reverse=True)
    torch.cuda.synchronize()
    print(f"[4] host set-up: generate {t_gen:.1f} s, relabel + build_ell"
          f" + upload {time.perf_counter() - t0:.1f} s")
    solves = bench.WARMUP + bench.ITERS
    panel.LAUNCHES.update(simt=0, tc=0)
    e1_before = spmv.LAUNCHES["ell"]
    record, g, res = bench.bench_pr(MAIN_SCALE, dev, g=g)
    launches = panel.LAUNCHES["simt"]
    e1_bench = spmv.LAUNCHES["ell"] - e1_before
    print(json.dumps(record))
    iters = res.iterations
    print(f"[4] rmat{MAIN_SCALE}: |V| {g.m} |E| {g.nnz}, {iters} "
          f"iterations, over {solves} solves K1 launches {launches} and E1 "
          f"launches {e1_bench}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not 0 < iters < 100:
        fail(f"PR did not converge: {iters} iterations")
    # "auto" on the card: the relabelled ELL layout, one E1 launch an
    # iteration and no K1
    if launches != 0 or e1_bench != solves * iters:
        fail(f"K1 launches {launches} != 0 or E1 launches {e1_bench} != "
             f"{solves} x {iters}")
    t0 = time.perf_counter()
    _, hyb, _ = views.relabeled_hybrid(g, dev)      # build_hybrid, upload
    torch.cuda.synchronize()
    n_panels = len(hyb.dense)
    print(f"[4] build_hybrid + upload {time.perf_counter() - t0:.1f} s: "
          f"{n_panels} panel arrays, {hyb.num_blocks} blocks")
    # one solve of each layout: "auto" runs E1 alone, "hybrid" K1 on every
    # panel array and E1 on the remainder, each iteration
    e1_solve = {}
    for layout in ("auto", "hybrid"):
        panel.LAUNCHES.update(simt=0, tc=0)
        e1_before = spmv.LAUNCHES["ell"]
        res = pr_solver(g, layout=layout, device=dev)
        one, e1 = panel.LAUNCHES["simt"], spmv.LAUNCHES["ell"] - e1_before
        e1_solve[layout] = e1
        scores = res.scores.cpu().numpy()
        if scores.shape != (g.m,) or not np.isfinite(scores).all():
            fail("scores are not finite of shape (m,)")
        resid = oracles.pagerank_push_residual(g, scores)
        print(f"[4] one {layout} solve: {res.iterations} iterations, K1 "
              f"launches {one}, E1 launches {e1}, residual {resid:.3e}")
        want = res.iterations * n_panels if layout == "hybrid" else 0
        pr_k1 = one
        if one != want:
            fail(f"K1 launches {one} != {want} ({layout})")
        if e1 != res.iterations:
            fail(f"E1 launches {e1} != {res.iterations} ({layout})")
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

    # the ELL remainder's padding, and the bytes bound of one f32 ELL
    # apply over it (each slot's column id, the operand and the output,
    # each once): the yardstick of the remainder's spmv_ell
    from gardenia_tpu_torch.ops.ell import ell_stats
    from gardenia_tpu_torch.ops.spmv import spmv_ell, spmv_ell_plain
    rem = ell_stats(hyb.rem)
    rem_edges = int(hyb.rem_dst.shape[0])
    ell_bytes = 4 * rem["slots"] + 4 * g.n + 4 * g.m
    ell_bound, ell_by = bound(ell_bytes, rem["slots"])
    # spmv_ell on the card is kernel E1 (csrc/ell_spmv.cu)
    y_e1 = spmv_ell(hyb.rem, x, num_rows=g.m)
    y_plain = spmv_ell_plain(hyb.rem, x, num_rows=g.m)
    e1_rel = float((y_e1 - y_plain).abs().max() / y_plain.abs().max())
    if not e1_rel <= 1e-6:
        fail(f"E1 disagrees with spmv_ell_plain: rel {e1_rel}")
    ell_ms = cuda_ms(lambda: spmv_ell(hyb.rem, x, num_rows=g.m))
    plain_ms = cuda_ms(lambda: spmv_ell_plain(hyb.rem, x, num_rows=g.m))
    print(f"[4] ELL remainder: ell_stats {json.dumps(rem)}, {rem_edges} "
          f"edges, padding {rem['slots'] / rem_edges:.4f} slots an "
          f"edge; one f32 apply's bound {ell_bytes / 1e6:.3f} MB -> "
          f"{ell_bound:.4f} ms ({ell_by}), spmv_ell alone (E1) "
          f"{ell_ms:.3f} ms, spmv_ell_plain {plain_ms:.3f} ms, E1 vs plain "
          f"rel {e1_rel:.3e}")

    # E1 at the main path's shape: the whole relabelled graph as one ELL
    # layout, the matrix that "auto" applies on the card, on the same x
    main_ell = views.ell(views.relabel_maps(g, dev)[0], dev, reverse=True)
    whole = ell_stats(main_ell)
    y_e1 = spmv_ell(main_ell, x, num_rows=g.m)
    y_plain = spmv_ell_plain(main_ell, x, num_rows=g.m)
    e1_main_rel = float((y_e1 - y_plain).abs().max() / y_plain.abs().max())
    if not e1_main_rel <= 1e-6:
        fail(f"E1 disagrees with spmv_ell_plain on the relabelled ELL "
             f"layout: rel {e1_main_rel}")
    e1_main_bytes = 4 * whole["slots"] + 4 * g.n + 4 * g.m
    e1_main_bound = bound(e1_main_bytes, whole["slots"])
    e1_main_ms = cuda_ms(lambda: spmv_ell(main_ell, x, num_rows=g.m))
    e1_main_plain = cuda_ms(lambda: spmv_ell_plain(main_ell, x,
                                                   num_rows=g.m))
    print(f"[4] relabelled ELL (auto's apply): ell_stats {json.dumps(whole)},"
          f" {g.nnz} edges; one f32 apply's bound "
          f"{e1_main_bytes / 1e6:.3f} MB -> {e1_main_bound[0]:.4f} ms "
          f"({e1_main_bound[1]}), E1 {e1_main_ms:.4f} ms, spmv_ell_plain "
          f"{e1_main_plain:.3f} ms, E1 vs plain rel {e1_main_rel:.3e}")
    del y_e1, y_plain

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
    # the library's yardstick: one BSR product over the whole dense part,
    # against K1's launches over every array plus the slot index_add_
    mb = (g.m + 127) // 128
    lib1 = library_yardstick(hyb, x3d, mb, torch.float32,
                             dense_part(hyb, x3d, mb), K1_REL_LIMIT)
    dense1_ms = cuda_ms(lambda: dense_part(hyb, x3d, mb), reps=5)
    print(f"[4] library yardstick at S=1 (torch.sparse_bsr_tensor f32 @ x): "
          f"{json.dumps(lib1)}; K1 over every array + the slot index_add_ "
          f"{dense1_ms:.3f} ms")
    torch.cuda.empty_cache()

    # ---- 5. TC kernels against their plain versions; R-MAT-16 TC --------
    clock(5)
    from gardenia_tpu_torch.ops import tc_count as tcc
    from gardenia_tpu_torch.solvers import tc
    stats = {name: {"mismatches": 0, "max_abs_err": 0, "pairs_checked": 0}
             for name in TC_KERNELS}
    data16 = tc.tc_data(tc.tc_dag(g16), True, dev)
    if data16.bitmap is None or len(data16.streams) != len(tc.ROT_WIDTHS):
        fail(f"rmat{SMOKE_SCALE} must give hub pairs and every width class")
    hold_tc_streams(data16, f"rmat{SMOKE_SCALE}", dev, stats, seed=5, phase=5)
    hold_edge_cases(data16.table, dev, stats)
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
    clock(6)
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

    # every stream of the main path, as uploaded and shuffled
    hold_tc_streams(data, f"rmat{MAIN_SCALE}", dev, stats, seed=6, phase=6)

    # per class at the main path's shapes: the routed kernel against its
    # plain version, in turns (plain, kernel, kernel, plain) on this card.
    # bound per routed class: the distinct rows the stream refers to and
    # the pair streams, each moved once (tc_need_bytes); operations as the
    # inputs need them (tc_ops)
    tc_ms = {name: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "ops": 0}
             for name in TC_KERNELS}
    breakdown = []
    for name, cls, W, rows, a, b in tc_streams(data):
        if W is not None and (name == "merge_count") != (
                W >= tc.MERGE_MIN_W):
            continue                        # not the route the solver takes
        n = a.shape[0]
        need = tc_need_bytes(name, rows, a, b, W)
        tc_ms[name]["bytes"] += need
        tc_ms[name]["ops"] += tc_ops(name, rows, a, b, W)
        nbytes = tc_read_bytes(name, rows, a, b, W)
        fn = {"kernel": functools.partial(tc_call, name, rows, a, b, W),
              "plain": functools.partial(tc_call, name, rows, a, b, W,
                                         plain=True)}
        t = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            t[which].append(cuda_ms(fn[which],
                                    reps=10 if which == "kernel" else 2,
                                    warmup=1))
        k_ms, p_ms = (sum(t[w]) / 2 for w in ("kernel", "plain"))
        tc_ms[name]["ms"] += k_ms
        tc_ms[name]["plain_ms"] += p_ms
        breakdown.append({"class": cls, "kernel": TC_KERNELS[name][0],
                          "pairs": n, "ms": k_ms, "plain_ms": p_ms,
                          "bytes_read": nbytes, "bytes_needed": need,
                          "gb_per_s": nbytes / k_ms / 1e6,
                          "runs": {w: [round(v, 4) for v in vs]
                                   for w, vs in t.items()}})
        print(f"[6] {TC_KERNELS[name][0]} {cls:>4}: {n:8d} pairs, kernel "
              f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, rows read "
              f"{nbytes / 1e9:.3f} GB -> {nbytes / k_ms / 1e6:.0f} GB/s; "
              f"the inputs need {need / 1e9:.3f} GB, "
              f"{need / HBM_BYTES_PER_S * 1e3:.3f} ms at the memory rate")
    # the crossover that MERGE_MIN_W is set by: on every class the kernel
    # the solver does not route there, timed as the routed one was
    routed = {e["class"]: e for e in breakdown if e["class"] != "hub"}
    cross = []
    for W, (cu, cv) in sorted(data.streams.items()):
        here = routed[f"W{W}"]
        took = {here["kernel"]: here["ms"]}
        for kernel, fn in (("K3", tcc.rot_count), ("K4", tcc.merge_count)):
            if kernel not in took:
                took[kernel] = cuda_ms(functools.partial(fn, data.table, cu,
                                                         cv, W), warmup=1)
        cross.append({"class": f"W{W}", "K3_ms": took["K3"],
                      "K4_ms": took["K4"], "routed": here["kernel"]})
    print(f"[6] K3/K4 crossover (MERGE_MIN_W = {tc.MERGE_MIN_W}), "
          + "; ".join(f"{c['class']}: K3 {c['K3_ms']:.3f} ms, K4 "
                      f"{c['K4_ms']:.3f} ms -> {c['routed']}"
                      for c in cross))
    print(f"[6] gpu: {gpu}")
    print("[6] tc breakdown " + json.dumps(breakdown))
    print("[6] TC kernels vs plain: " + json.dumps(stats))

    # ---- 7. K2 against its plain version; CC on uniform-14 ---------------
    clock(7)
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
    clock(8)
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


    # ---- 9. K1 at the batched shape against its plain version ------------
    clock(9)
    from gardenia_tpu_torch.cli import bc_close
    from gardenia_tpu_torch.solvers import bc, bfs
    kb_stats = {"arrays_checked": 0, "mismatches": 0, "max_abs_err": 0.0,
                "max_rel_err": 0.0, "max_rel_err_bf16": 0.0,
                "w32_rel_f32": 0.0, "w32_rel_bf16": 0.0,
                "mask_elements": 0, "mask_mismatches": 0}
    before_check = dict(panel.LAUNCHES)
    check_k1_batched(hyb16, f"rmat{SMOKE_SCALE}", K1_BATCH_S, dev, kb_stats)
    for kind, hw in weighted.items():
        check_k1_batched(hw, f"weighted-{kind}", K1_BATCH_S, dev, kb_stats)
    k1_batched_edge_cases(dev, kb_stats)
    small_rel = kb_stats["max_rel_err"]
    kb_stats["max_abs_err"] = 0.0       # below: the main path's shapes only
    check_k1_batched(hyb, f"rmat{MAIN_SCALE}", (SOURCES,), dev, kb_stats)
    by_route = {k: panel.LAUNCHES[k] - before_check[k]
                for k in before_check}
    print(f"[9] K1 batched vs plain: {json.dumps(kb_stats)}; worst rel at "
          f"the small shapes {small_rel:.3e}; launches of the check by "
          f"route {by_route} (f32 panels take the CUDA-core kernel)")
    if by_route["tc"] == 0 or kb_stats["mask_mismatches"]:
        fail("the tensor-core kernel did not run, or a mask product is "
             "inexact")
    # the f32 operand's split into three bf16 terms: exact, bit for bit
    split_checked = 0
    for S in (9, 100, SOURCES):
        xs = torch.from_numpy(np.random.default_rng(S).random(
            (g.n // 128, 128, S)).astype(np.float32) * 1e3 - 500).to(dev)
        before = panel.SPLIT_LAUNCHES["split"]
        got, want = panel.split_operand(xs), panel.split_operand_plain(xs)
        if panel.SPLIT_LAUNCHES["split"] != before + 1 or \
                not torch.equal(got, want):
            fail(f"the split kernel differs from its plain version at S={S}")
        split_checked += got.numel()
    del xs, got, want
    print(f"[9] split_operand's kernel equal to its plain version, bit for "
          f"bit: {split_checked} bf16 terms (S = 9, 100, {SOURCES}); worst "
          f"rel on the W = 32 arrays: f32 operand "
          f"{kb_stats['w32_rel_f32']:.3e}, bf16 operand "
          f"{kb_stats['w32_rel_bf16']:.3e}")

    # ---- 10. BFS, multi-source BFS and BC on R-MAT-16 --------------------
    clock(10)
    src16 = int(np.argmax(g16.degrees))
    t0 = time.perf_counter()
    want_d16 = oracles.bfs_serial(g16, src16)
    t_or = time.perf_counter() - t0
    for variant, layouts in (("pull", ("hybrid", "ell")), ("do", (None,)),
                             ("do_fused", ("hybrid", "ell"))):
        for layout in layouts:
            kw = {} if layout is None else {"layout": layout}
            r16 = bfs.VARIANTS[variant](g16, src16, device=dev, **kw)
            same = bool((r16.dist.cpu().numpy() == want_d16).all())
            print(f"[10] bfs {variant} {layout or '-'} rmat{SMOKE_SCALE}: "
                  f"{r16.iterations} iterations, depths "
                  f"{'equal' if same else 'NOT equal'} to the serial oracle")
            if not same or r16.dist.dtype != torch.int32:
                fail(f"bfs {variant} {layout} disagrees with the serial "
                     f"oracle at rmat{SMOKE_SCALE}")
    srcs16 = (np.arange(BATCH_SMOKE_SOURCES) * 4099) % g16.m
    single = [bfs.bfs_pull(g16, int(sv), layout="ell", device=dev).dist
              for sv in srcs16]
    for layout in ("hybrid", "ell"):
        panel.LAUNCHES.update(simt=0, tc=0)
        ms16 = bfs.bfs_multi_source(g16, srcs16, layout=layout, device=dev)
        bad = sum(int((ms16.dist[:, j] != single[j]).sum())
                  for j in range(len(srcs16)))
        print(f"[10] msbfs {layout} rmat{SMOKE_SCALE}, {len(srcs16)} "
              f"sources: {ms16.iterations} levels, {bad} depths differ from "
              f"the single-source solver, K1 launches {panel.LAUNCHES}")
        if bad or tuple(ms16.dist.shape) != (g16.m, len(srcs16)):
            fail(f"bfs_multi_source ({layout}) disagrees with bfs_pull")
        if (layout == "hybrid") != (panel.LAUNCHES["tc"] > 0):
            fail(f"msbfs {layout}: K1 launches {panel.LAUNCHES}")
    t0 = time.perf_counter()
    want_bc16 = oracles.bc_serial(g16, src16)
    t_or += time.perf_counter() - t0
    delta16 = {int(sv): brandes_numpy(g16, int(sv)) for sv in srcs16}
    ref_one = normalized(brandes_numpy(g16, src16))
    one16 = bc.bc_solver(g16, src16, device=dev)
    ok_ref = bc_close(ref_one, want_bc16)
    ok_one = bc_close(one16.scores.cpu().numpy(), want_bc16)
    print(f"[10] bc_solver rmat{SMOKE_SCALE} source {src16}: "
          f"{one16.iterations} levels, vs serial oracle "
          f"{'Correct' if ok_one else 'Wrong'}; numpy Brandes vs serial "
          f"oracle {'Correct' if ok_ref else 'Wrong'} (serial oracles "
          f"{t_or:.1f} s)")
    if not (ok_ref and ok_one):
        fail("bc_solver or the numpy Brandes disagrees with the serial "
             "oracle")
    want_multi = normalized(sum(delta16.values()))
    for layout in ("hybrid", "ell"):
        b16 = bc.bc_batched(g16, srcs16, layout=layout, device=dev)
        ok = bc_close(b16.scores.cpu().numpy(), want_multi)
        print(f"[10] bc_batched {layout} rmat{SMOKE_SCALE}, {len(srcs16)} "
              f"sources: {b16.iterations} levels, vs the numpy Brandes "
              f"{'Correct' if ok else 'Wrong'}")
        if not ok:
            fail(f"bc_batched ({layout}) disagrees with the reference")

    # ---- 11. the BFS / MS-BFS / BC main path at R-MAT-20 -----------------
    clock(11)
    solves = bench.WARMUP + bench.ITERS
    taken = []
    pick = bfs._pick_branch
    bfs._pick_branch = lambda *a: (taken.append(pick(*a)), taken[-1])[1]
    try:
        panel.LAUNCHES.update(simt=0, tc=0)
        rec_bfs, g, res_bfs = bench.bench_bfs(MAIN_SCALE, dev, g=g)
    finally:
        bfs._pick_branch = pick
    bfs_routes = dict(panel.LAUNCHES)
    print(json.dumps(rec_bfs))
    n_tiers = len(bfs.fused_tiers(g.m, g.nnz))
    per_solve = taken[:res_bfs.iterations]
    dense_levels = sum(1 for i in per_solve if i == 2 * n_tiers)
    print(f"[11] bfs_do_fused rmat{MAIN_SCALE} from "
          f"{rec_bfs['detail']['source']}: {res_bfs.iterations} levels, "
          f"branches {per_solve} "
          f"({dense_levels} dense sweeps), K1 launches {bfs_routes} over "
          f"{solves} solves")
    if bfs_routes != {"simt": dense_levels * n_panels * solves, "tc": 0}:
        fail(f"bfs K1 launches {bfs_routes} != dense levels x arrays x solves")
    t0 = time.perf_counter()
    want_d = oracles.bfs_serial(g, rec_bfs["detail"]["source"])
    same = bool((res_bfs.dist.cpu().numpy() == want_d).all())
    print(f"[11] bfs_do_fused depths {'equal' if same else 'NOT equal'} to "
          f"the serial oracle ({time.perf_counter() - t0:.1f} s); "
          f"{int((want_d < bfs.INF).sum())} vertices reached, eccentricity "
          f"{int(want_d[want_d < bfs.INF].max())}")
    if not same:
        fail(f"bfs_do_fused disagrees with the serial oracle at "
             f"rmat{MAIN_SCALE}")
    bfs_ms = {}
    for variant in ("do_fused", "pull"):
        for layout in ("hybrid", "ell"):
            fn = functools.partial(bfs.VARIANTS[variant], g,
                                   rec_bfs["detail"]["source"], layout=layout,
                                   device=dev)
            if not bool((fn().dist.cpu().numpy() == want_d).all()):
                fail(f"bfs {variant} {layout} disagrees with the oracle")
            t = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
            bfs_ms[f"{variant} {layout}"] = min(t)
    print(f"[11] gpu: {gpu}")
    print(f"[11] single-source BFS solve ms (best of 3, host clock), hybrid "
          f"beside ell: " + json.dumps(bfs_ms))

    panel.LAUNCHES.update(simt=0, tc=0)
    rec_ms, g, res_ms = bench.bench_msbfs(MAIN_SCALE, dev, g=g)
    ms_routes = dict(panel.LAUNCHES)
    print(json.dumps(rec_ms))
    print(f"[11] msbfs rmat{MAIN_SCALE}, {SOURCES} sources: "
          f"{res_ms.iterations} levels, K1 launches {ms_routes} over "
          f"{solves} solves ({n_panels} panel arrays)")
    if ms_routes != {"simt": 0,
                     "tc": res_ms.iterations * n_panels * solves}:
        fail(f"msbfs K1 launches {ms_routes} != levels x arrays x solves, "
             f"all by the tensor-core kernel")
    t0 = time.perf_counter()
    want_ms = bfs_depths_bits(g, np.arange(SOURCES))
    bits_s = time.perf_counter() - t0
    bad_cols = int((res_ms.dist.cpu().numpy() != want_ms).any(axis=0).sum())
    t0 = time.perf_counter()
    scipy_ms = bfs_depths_scipy(g, np.arange(MSBFS_SCIPY_COLUMNS))
    bad_scipy = int((scipy_ms != want_ms[:, :MSBFS_SCIPY_COLUMNS]).any(
        axis=0).sum())
    print(f"[11] msbfs depths vs a numpy bitset BFS: {bad_cols} of "
          f"{SOURCES} columns differ ({bits_s:.1f} s); that BFS vs scipy "
          f"breadth_first_order: {bad_scipy} of its first "
          f"{MSBFS_SCIPY_COLUMNS} columns differ "
          f"({time.perf_counter() - t0:.1f} s); sources that reach more "
          f"than themselves: "
          f"{int(((want_ms < bfs.INF).sum(axis=0) > 1).sum())}")
    if bad_cols or bad_scipy or tuple(res_ms.dist.shape) != (g.m, SOURCES):
        fail("bfs_multi_source disagrees with the independent reference")
    del res_ms, want_ms, scipy_ms

    bc_solves = bench.BC_WARMUP + bench.BC_ITERS
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    panel.LAUNCHES.update(simt=0, tc=0)
    panel.SPLIT_LAUNCHES["split"] = 0
    rec_bc, g, res_bc = bench.bench_bc(MAIN_SCALE, dev, g=g)
    bc_routes = dict(panel.LAUNCHES)
    bc_split = panel.SPLIT_LAUNCHES["split"]
    peak_bc = torch.cuda.max_memory_allocated() - resident
    print(json.dumps(rec_bc))
    bc_sweeps = 2 * res_bc.iterations          # forward + backward levels
    print(f"[11] bc_batched rmat{MAIN_SCALE}, {SOURCES} sources: "
          f"{res_bc.iterations} forward levels, K1 launches {bc_routes} over"
          f" {bc_solves} solves, peak device memory of the solve "
          f"{peak_bc / 2**30:.2f} GiB above the {resident / 2**30:.2f} GiB "
          f"resident before it")
    if bc_routes != {"simt": 0, "tc": bc_sweeps * n_panels * bc_solves}:
        fail(f"bc K1 launches {bc_routes} != (forward + backward levels) x "
             f"arrays x solves, all by the tensor-core kernel")
    if bc_split != bc_sweeps * bc_solves:
        fail(f"split launches {bc_split} != one an apply "
             f"({bc_sweeps} x {bc_solves})")
    sc = res_bc.scores.cpu().numpy()
    if sc.shape != (g.m,) or not np.isfinite(sc).all() or sc.max() != 1.0:
        fail("bc scores are not finite of shape (m,) with a max of 1")
    t0 = time.perf_counter()
    sc_ell = bc.bc_batched(g, np.arange(SOURCES), layout="ell",
                           device=dev).scores.cpu().numpy()
    torch.cuda.synchronize()
    ok = bc_close(sc, sc_ell)
    print(f"[11] bc_batched hybrid vs its panel-free ell route "
          f"({time.perf_counter() - t0:.1f} s): max|diff| "
          f"{float(np.abs(sc - sc_ell).max()):.3e}: "
          f"{'Correct' if ok else 'Wrong'}")
    if not ok:
        fail("bc_batched disagrees with its ell route")
    for sv in (0, rec_bfs["detail"]["source"]):
        t0 = time.perf_counter()
        want_sv = normalized(brandes_numpy(g, sv))
        got = {"bc_batched hybrid, one source": bc.bc_batched(
                   g, [sv], device=dev).scores.cpu().numpy(),
               "bc_solver": bc.bc_solver(g, sv, device=dev).scores.cpu()
               .numpy()}
        oks = {k: bc_close(v, want_sv) for k, v in got.items()}
        print(f"[11] source {sv} vs the numpy Brandes "
              f"({time.perf_counter() - t0:.1f} s): " + json.dumps(oks))
        if not all(oks.values()):
            fail(f"BC from source {sv} disagrees with the numpy Brandes")
    del res_bc

    # one spmv_hybrid_batched apply at the main path's shapes
    rng = np.random.default_rng(12)
    xf = torch.from_numpy(rng.random((g.n, SOURCES)).astype(np.float32)) \
        .to(dev)
    xm = (xf < 0.3).to(torch.bfloat16)
    qx = g.n // 128
    x3f, x3m = xf.view(qx, 128, SOURCES), xm.view(qx, 128, SOURCES)
    arrays = [(p.panel, p.src) for p in hyb.dense]

    def k1w(x3):
        """K1 on every panel array, as spmv_hybrid_batched calls it: the
        f32 operand's split (once) inside the timed sweep."""
        return panel.dense_panel_matmul_arrays(arrays, x3, SOURCES)

    def k1p(x3):
        return [panel.dense_panel_matmul_plain(pn, src, x3, SOURCES)
                for pn, src in arrays]

    def simt_sweep():
        """The CUDA-core kernel at S = 128, where the wrapper no longer
        sends int8 panels: its entry, called as the wrapper calls it."""
        from gardenia_tpu_torch.ops import _build
        stream = torch.cuda.current_stream().cuda_stream
        outs = []
        for p in hyb.dense:
            out = torch.empty((p.src.shape[0], 128, SOURCES),
                              dtype=torch.float32, device=dev)
            _build.check(_build.lib().gdn_dense_panel_matmul(
                p.panel.data_ptr(), 0, p.src.data_ptr(), x3f.data_ptr(),
                out.data_ptr(), *p.src.shape, SOURCES, stream),
                "dense_panel_matmul (simt)")
            outs.append(out)
        return outs

    kb_ms, kb_runs = {}, {}
    for name, x3 in (("f32", x3f), ("bf16", x3m)):
        m_, r_ = turns({"kernel": functools.partial(k1w, x3),
                        "plain": functools.partial(k1p, x3)},
                       reps={"kernel": 5, "plain": 1})
        kb_ms[name], kb_runs[name] = m_, r_
    if any(p.panel.dtype != torch.int8 for p in hyb.dense):
        fail(f"rmat{MAIN_SCALE}'s panels are not int8")
    for y_s, y_t in zip(simt_sweep(), k1w(x3f)):
        rel = float((y_s - y_t).abs().max() / y_t.abs().max())
        if not rel < K1_REL_LIMIT:
            fail(f"K1's two kernels disagree at S={SOURCES}: rel {rel}")
    del y_s, y_t
    simt_ms = cuda_ms(simt_sweep, reps=2, warmup=1)
    panel.SPLIT_LAUNCHES["split"] = 0
    split_ms = {"kernel": cuda_ms(lambda: panel.split_operand(x3f), reps=5),
                "plain": cuda_ms(lambda: panel.split_operand_plain(x3f),
                                 reps=3)}
    # the library's yardstick over the whole dense part, against K1's
    # launches over every array plus the slot index_add_
    mb = (g.m + 127) // 128
    lib128, dense128_ms = {}, {}
    for name, x3, dtype, limit in (
            ("f32", x3f, torch.float32, K1_REL_LIMIT),
            ("bf16", x3m, torch.bfloat16, K1_BF16_REL_LIMIT)):
        lib128[name] = library_yardstick(hyb, x3, mb, dtype,
                                         dense_part(hyb, x3, mb), limit)
        dense128_ms[name] = cuda_ms(lambda: dense_part(hyb, x3, mb), reps=3,
                                    warmup=1)
        torch.cuda.empty_cache()
    zeros = functools.partial(torch.zeros, (g.m, SOURCES), device=dev)
    rem_ms = {
        "segment_reduce f32": cuda_ms(lambda: bsr.batched_remainder(
            hyb, xf, g.m), reps=3, warmup=1),
        "segment_reduce bf16 mask": cuda_ms(lambda: bsr.batched_remainder(
            hyb, xm, g.m), reps=3, warmup=1),
        "index_add_ f32": cuda_ms(lambda: zeros().index_add_(
            0, hyb.rem_dst, xf[hyb.rem_src]), reps=3, warmup=1)}
    apply_ms = {name: cuda_ms(lambda: bsr.spmv_hybrid_batched(
        hyb, x, num_rows=g.m), reps=3, warmup=1)
        for name, x in (("f32", xf), ("bf16 mask", xm))}
    slots = sum(p.src.shape[0] for p in hyb.dense)
    _, cells, nz = panel_work(hyb, 0)
    panel_bytes = sum(p.panel.numel() * p.panel.element_size()
                      + p.src.numel() * 4 for p in hyb.dense)
    out_bytes = slots * 128 * SOURCES * 4
    kb_bound, kb_read = {}, {}
    for name, x_el, terms in (("f32", 4, 3), ("bf16", 2, 1)):
        need = panel_bytes + qx * 128 * SOURCES * x_el + out_bytes
        # the products the data needs: the nonzero cells' (a multiply
        # and an add for each column and bf16 term), not every cell's
        kb_bound[name] = bound(need, 2 * nz * SOURCES * terms,
                               TENSOR_BF16_OPS_PER_S)
        # as designed: every block's operand tile is staged once per slot,
        # one bf16 tile a term; an f32 operand's split reads it once and
        # writes its three terms
        kb_read[name] = (panel_bytes + out_bytes
                         + hyb.num_blocks * 128 * SOURCES * 2 * terms
                         + (qx * 128 * SOURCES * (4 + 6) if terms == 3
                            else 0))
    print(f"[11] gpu: {gpu}")
    print(f"[11] dense panels, one sweep at S={SOURCES} ({slots} slots, "
          f"{hyb.num_blocks} blocks, {nz} nonzero of {cells} cells): "
          + "; ".join(
              f"{name} operand: kernel {kb_ms[name]['kernel']:.3f} ms, plain "
              f"{kb_ms[name]['plain']:.3f} ms, bound {kb_bound[name][0]:.3f}"
              f" ms ({kb_bound[name][1]}), the design reads "
              f"{kb_read[name] / 1e9:.2f} GB -> "
              f"{kb_read[name] / kb_ms[name]['kernel'] / 1e6:.0f} GB/s"
              for name in ("f32", "bf16"))
          + f"; the CUDA-core kernel at S={SOURCES} (16 passes) "
          f"{simt_ms:.3f} ms (runs " + json.dumps(
              {n_: {k: [round(v, 3) for v in vs] for k, vs in r_.items()}
               for n_, r_ in kb_runs.items()}) + ")")
    print(f"[11] f32 operand's split alone: kernel {split_ms['kernel']:.3f} "
          f"ms, plain {split_ms['plain']:.3f} ms; library yardstick "
          f"(torch.sparse_bsr_tensor @ operand, f32 values with the f32 "
          f"operand, bf16 values with the mask): {json.dumps(lib128)}; K1 "
          f"over every array + the slot index_add_ "
          f"{json.dumps(dense128_ms)} ms")
    print(f"[11] the batched remainder, {hyb.rem_dst.shape[0]} edges x "
          f"{SOURCES * 4} B rows: " + json.dumps(rem_ms)
          + "; the whole apply: " + json.dumps(apply_ms))
    del xf, xm, x3f, x3m

    # ---- 12. C5: cc_sv's ell layout beside hybrid ------------------------
    clock(12)
    from gardenia_tpu_torch.core.graph import from_csr_of
    for label, graph in ((f"rmat{MAIN_SCALE}", g),
                         (f"uniform{CC_UNIFORM_SCALE}", gu)):
        for layout in ("ell", "hybrid"):
            fresh = from_csr_of(graph)          # same arrays, empty caches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            first = cc.cc_sv(fresh, layout=layout, device=dev)
            torch.cuda.synchronize()
            t_first = time.perf_counter() - t0
            t = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                cc.cc_sv(fresh, layout=layout, device=dev)
                torch.cuda.synchronize()
                t.append((time.perf_counter() - t0) * 1e3)
            built = None
            if layout == "hybrid":      # did a dense round ask for it?
                g2f = views.relabel_maps(fresh, dev)[0]
                built = views._key("hybrid", dev, views._dir(g2f, False)) \
                    in g2f._device_cache
            print(f"[12] cc_sv {layout:6s} {label}: first solve "
                  f"{t_first:.2f} s, then best of 3 {min(t):.3f} ms "
                  f"({first.iterations} rounds"
                  + ("" if built is None else
                     f"; hybrid layout built: {built}") + ")")
            if layout == "hybrid" and label.startswith("rmat"):
                t0 = time.perf_counter()
                views.hybrid(views.relabel_maps(fresh, dev)[0], dev)
                torch.cuda.synchronize()
                print(f"[12] building and uploading the hybrid layout of "
                      f"{label}, which the first solve no longer does: "
                      f"{time.perf_counter() - t0:.2f} s")
            del fresh
    print(f"[12] gpu: {gpu}")

    # ---- 13. SpMV: threshold-64 layouts, variants, the R-MAT-20 bench ----
    clock(13)
    spmv13 = spmv_phase(dev, gpu, g, hyb, k1_stats)

    # ---- 14. SSSP: four variants at R-MAT-16, the grid-1024 bench --------
    clock(14)
    f1_entry = sssp_phase(dev, gpu)

    # ---- 15. MST, SCC, clustering and random walks ------------------------
    clock(15)
    mst_scc_phase(dev, gpu, g)

    # ---- 16. VC: V1 against its plain version, the solver, the bench ------
    clock(16)
    v1_entry, g16 = vc_phase(dev, gpu, g)

    # ---- 17. SymGS: the serial sweep at R-MAT-16, the R-MAT-20 bench ------
    clock(17)
    gs1_entry = symgs_phase(dev, gpu, g, g16)

    # ---- 18. SGD: the f64 replica at R-MAT-16, the R-MAT-20 bench ---------
    clock(18)
    sgd_phase(dev, gpu, g, g16)

    # ---- 19. kCL: Q1 against its plain version, the R-MAT-20 bench --------
    clock(19)
    q1_entry = kcl_phase(dev, gpu, g, g16)

    # ---- 20. motif: the census at R-MAT-16 and R-MAT-20 -------------------
    clock(20)
    motif_launches, census20 = motif_phase(
        dev, gpu, g, g16,
        {name: n // (bench.TC_WARMUP + bench.TC_ITERS)
         for name, n in tc_launches.items()})
    motif_path = f"motif bench rmat{MAIN_SCALE}"
    q1_entry["launches"] += motif_launches["kcl_local_count"]
    q1_entry["launches_by_path"][motif_path] = \
        motif_launches["kcl_local_count"]

    # ---- 21. SGL: diamond at R-MAT-16 and R-MAT-20, the pattern engine ---
    clock(21)
    sgl_q1 = sgl_phase(dev, gpu, g, g16, census20)
    q1_entry["launches"] += sgl_q1
    q1_entry["launches_by_path"][f"sgl bench rmat{MAIN_SCALE}"] = sgl_q1

    # ---- 22. FSM: the label aggregate at R-MAT-16 and R-MAT-20, gSpan ----
    clock(22)
    fsm22 = fsm_phase(dev, gpu, g, g16)

    # ---- 23. the multi-device path: dist solvers on 1 and 2 ranks --------
    clock(23)
    dist23, dist_holds, p24 = dist_phase(dev, gpu, g, g16)
    dist_simt = {p: c["simt"] for p, c in dist23.items() if "simt" in c}
    dist_tc = {p: c["tc"] for p, c in dist23.items() if "tc" in c}

    entries = [{
        "name": "dense_panel_matmul", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": launches + pr_k1 + bfs_routes["simt"]
        + spmv13["launches"] + sum(dist_simt.values()),
        "launches_by_path": {f"pr bench rmat{MAIN_SCALE}": launches,
                             f"pr hybrid solve rmat{MAIN_SCALE}": pr_k1,
                             f"bfs bench rmat{MAIN_SCALE}":
                             bfs_routes["simt"],
                             f"spmv bench rmat{MAIN_SCALE}":
                             spmv13["launches"], **dist_simt},
        # K1 on each rank's shard against its plain version, and the
        # shard's apply against scipy, by dist path
        "dist_holds": {p: h for p, h in dist_holds.items()
                       if not p.startswith(("msbfs", "bc "))},
        "mismatches": k1_stats["mismatches"],
        "max_abs_err": main_abs, "ms": ms["dense_k1"],
        "plain_ms": ms["dense_plain"],
        # the same bytes as K2's sweep (S = 1: one f32 out per row), a
        # multiply and an add per cell
        **dict(zip(("bound_ms", "bound_by"), bound(k2_bytes, 2 * cells))),
        "dense_with_index_add_ms": dense1_ms, **lib1}, {
        # K1 at the batched shape: ms, plain_ms and bound are the f32
        # operand's (BC's sweep); the bf16 operand's (MS-BFS's) beside them
        "name": "dense_panel_matmul_tc", "route": "cuda",
        "source": K1_TC_SOURCE, "replaces": K1_REPLACES, "columns": SOURCES,
        "launches": ms_routes["tc"] + bc_routes["tc"] + fsm22["launches"]
        + sum(dist_tc.values()),
        "launches_by_path": {f"msbfs bench rmat{MAIN_SCALE}": ms_routes["tc"],
                             f"bc bench rmat{MAIN_SCALE}": bc_routes["tc"],
                             f"fsm bench rmat{MAIN_SCALE}":
                             fsm22["launches"], **dist_tc},
        "dist_holds": {p: h for p, h in dist_holds.items()
                       if p.startswith(("msbfs", "bc "))},
        "mismatches": kb_stats["mismatches"] + fsm22["mismatches"],
        "max_abs_err": kb_stats["max_abs_err"],
        "ms": kb_ms["f32"]["kernel"], "plain_ms": kb_ms["f32"]["plain"],
        "bound_ms": kb_bound["f32"][0], "bound_by": kb_bound["f32"][1],
        "bytes_read": kb_read["f32"],
        "ms_bf16_operand": kb_ms["bf16"]["kernel"],
        "plain_ms_bf16_operand": kb_ms["bf16"]["plain"],
        "bound_ms_bf16_operand": kb_bound["bf16"][0],
        "bytes_read_bf16_operand": kb_read["bf16"],
        "simt_route_ms": simt_ms,
        "resources": tc_info,
        "w32_rel_f32": kb_stats["w32_rel_f32"],
        "w32_rel_bf16": kb_stats["w32_rel_bf16"],
        "dense_with_index_add_ms": dense128_ms["f32"],
        "dense_with_index_add_ms_bf16_operand": dense128_ms["bf16"],
        # the fsm bench's bf16 0/1 operands: S = L labels, S = L * L lanes
        **{f"{k}_fsm_s{S}": v for S, row in fsm22["by_columns"].items()
           for k, v in row.items()},
        **lib128["f32"],
        **{f"{k}_bf16_operand": v for k, v in lib128["bf16"].items()}}, {
        # the f32 operand's split into three bf16 terms, once an apply of
        # the BC bench (bc_batched's applies all take an f32 operand)
        "name": "split_operand", "route": "cuda", "source": K1_TC_SOURCE,
        "replaces": SPLIT_REPLACES, "launches": bc_split,
        "launches_by_path": {f"bc bench rmat{MAIN_SCALE}": bc_split},
        "mismatches": 0, "max_abs_err": 0.0, "ms": split_ms["kernel"],
        "plain_ms": split_ms["plain"],
        # reads the f32 operand, writes three bf16 terms; no arithmetic
        # beyond the roundings
        **dict(zip(("bound_ms", "bound_by"), bound(
            qx * 128 * SOURCES * (4 + 3 * 2), 6 * qx * 128 * SOURCES))),
        "library_ms": None}, {
        "name": "dense_panel_minselect", "route": "cuda",
        "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": k2_bench + k2_uniform + sum(p24["k2_paths"].values()),
        "launches_by_path": {f"cc bench rmat{MAIN_SCALE}": k2_bench,
                             f"cc_sv uniform{CC_UNIFORM_SCALE}": k2_uniform,
                             **p24["k2_paths"]},
        # every K2 call of the dist CC paths' first solves against the
        # plain version, exactly, by path
        "dist_holds": p24["k2_holds"],
        "mismatches": k2_stats["mismatches"],
        "max_abs_err": k2_stats["max_abs_err"], "ms": cc_ms["dense_k2"],
        "plain_ms": cc_ms["dense_plain"],
        "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
        "library_ms": None}, {
        # M1 at the one-rank R-MAT-20 SSSP shard (its whole dense part);
        # launches are the dist SSSP paths' second solves
        "name": "dense_panel_minplus", "route": "cuda",
        "source": K2_SOURCE, "replaces": M1_REPLACES,
        "launches": sum(p24["m1_paths"].values()),
        "launches_by_path": p24["m1_paths"],
        "dist_holds": p24["m1_holds"], "hand_cases": p24["m1_hand"],
        "mismatches": p24["m1_hand"]["mismatches"],
        "max_abs_err": p24["m1_hand"]["max_abs_err"],
        **{k: p24["m1_time"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "k2_ms_same_panels",
            "bytes", "nonzero_cells", "cells")},
        "library_ms": None}]
    for name, (_, source, replaces) in TC_KERNELS.items():
        b_ms, b_by = bound(tc_ms[name]["bytes"], tc_ms[name]["ops"])
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": tc_launches[name] + motif_launches[name],
            "launches_by_path": {f"tc bench rmat{MAIN_SCALE}":
                                 tc_launches[name],
                                 motif_path: motif_launches[name]},
            "mismatches": stats[name]["mismatches"],
            "max_abs_err": stats[name]["max_abs_err"],
            "ms": tc_ms[name]["ms"], "plain_ms": tc_ms[name]["plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    entries.append({
        # E1 at PR's main path on the card: the whole relabelled R-MAT
        # graph as one ELL layout; the remainder's apply beside it
        "name": "ell_spmv", "route": "cuda", "source": E1_SOURCE,
        "replaces": E1_REPLACES,
        "launches": e1_bench + sum(e1_solve.values()),
        "launches_by_path": {f"pr bench rmat{MAIN_SCALE}": e1_bench,
                             f"pr auto solve rmat{MAIN_SCALE}":
                             e1_solve["auto"],
                             f"pr hybrid solve rmat{MAIN_SCALE}":
                             e1_solve["hybrid"]},
        "launches_whole_run": spmv.LAUNCHES["ell"],
        "mismatches": 0, "max_rel_err": e1_main_rel,
        "ms": e1_main_ms, "plain_ms": e1_main_plain,
        "bound_ms": e1_main_bound[0], "bound_by": e1_main_bound[1],
        "slots": whole["slots"], "buckets": whole["buckets"],
        "remainder_ms": ell_ms, "remainder_plain_ms": plain_ms,
        "remainder_bound_ms": ell_bound, "remainder_max_rel_err": e1_rel,
        "library_ms": None})
    entries.append(v1_entry)
    entries.append(q1_entry)
    entries.append(f1_entry)
    entries.append(gs1_entry)
    print(f"[24] the whole run: {time.perf_counter() - RUN_START:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
