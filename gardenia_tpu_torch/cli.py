"""Benchmark CLI of the port — the `pr`, `spmv`, `bfs`, `sssp`, `cc`, `bc`,
`tc`, `scc`, `mst`, `vc`, `symgs`, `sgd`, `kcl`, `motif`, `sgl` and `fsm`
kernels (all 16 of the reference's), with the positional argv of
gardenia_tpu/cli.py:

  python -m gardenia_tpu_torch.cli <kernel> <filetype> <graph-prefix|scale>
                                   [symmetrize] [kernel args...]
                                   [--variant=NAME] [--device={cuda,cpu}]
e.g.
  python -m gardenia_tpu_torch.cli pr rmat 20
  python -m gardenia_tpu_torch.cli pr mtx soc-LiveJournal1 0 --device=cpu
  python -m gardenia_tpu_torch.cli pr rmat 20 --variant=delta
  python -m gardenia_tpu_torch.cli tc rmat 20 --variant=bsearch
  python -m gardenia_tpu_torch.cli cc rmat 20 --variant=afforest
  python -m gardenia_tpu_torch.cli bfs rmat 20 1 0 5 --variant=do_fused
  python -m gardenia_tpu_torch.cli bc rmat 20
  python -m gardenia_tpu_torch.cli spmv rmat 20 1 --variant=hybrid
  python -m gardenia_tpu_torch.cli sssp rmat 20 1 0 0 64 --variant=nearfar
  python -m gardenia_tpu_torch.cli scc rmat 20 --variant=wcc
  python -m gardenia_tpu_torch.cli mst rmat 20
  python -m gardenia_tpu_torch.cli vc rmat 20
  python -m gardenia_tpu_torch.cli symgs rmat 16
  python -m gardenia_tpu_torch.cli sgd rmat 20 0 0 0.05 0.003 3
  python -m gardenia_tpu_torch.cli kcl rmat 20 1 4
  python -m gardenia_tpu_torch.cli motif rmat 16 1 4
  python -m gardenia_tpu_torch.cli sgl rmat 16 1 diamond
  python -m gardenia_tpu_torch.cli fsm rmat 16 5000 2

Flags may stand anywhere among the positionals, as in the reference's CLI
(`--device cpu` in two words is taken too); an unknown flag prints a
message and returns 1.  The device is cuda unless asked otherwise.
`--dist=n` runs pr, bfs, tc, vc or scc on n ranks (parallel/, one process
a rank, started by parallel.mesh.run_on_ranks), as gardenia_tpu/cli.py
does over an n-device mesh: it prints 'mesh: n ranks (<backend>,
<devices>)' and 'runtime [<kernel>_dist<n>] = X ms.' and checks against
the same oracles; any other kernel prints that it has no multi-device
path yet and returns 1, and --variant is ignored there.
  python -m gardenia_tpu_torch.cli pr rmat 20 --dist=2
  python -m gardenia_tpu_torch.cli bfs rmat 10 1 0 5 --dist=2 --device=cpu

Each kernel prints the reference's contract lines: '|V| <m> |E| <nnz>',
the kernel's own lines (pr: the error trace, 'runtime [<variant>] = X
ms.', 'GTEPS = ...'; tc: 'runtime [<variant>] = X sec',
'total_num_triangles = N'; cc: 'runtime [<variant>] = X ms.',
'num_components = N'; bfs and bc: 'iterations = N.', 'runtime [<variant>]
= X ms.', bfs also 'GTEPS = ...'; spmv: 'runtime [<variant>] = X ms (
G GFLOP/s B GB/s)'; sssp: 'iterations = N.' and the runtime; scc:
the runtime and 'number of SCCs = N'; mst: the runtime and 'MST weight =
W'; vc: 'runtime [base] = X ms, num_colors = N.'; symgs: the runtime;
sgd: 'Iteration i: RMSE error = E' per epoch, 'iterations = N.' and the
runtime; kcl: the runtime, 'total_num_cliques = N' and the route with
Q1's launches; motif: the runtime, '<pattern>: N' a line and, at k = 4,
which aggregates ran; sgl: the runtime and 'total_num_<pattern> = N';
fsm: 'minsup = ', 'k = ', the runtime and 'Number of frequent subgraphs
(minsup=S): N') and the serial oracle's 'Correct'/'Wrong' (vc: a proper
colouring; symgs: l2 error < 1e-4 against the serial sweep, a
pure-Python loop that takes minutes at R-MAT-20; sgd: a finite RMSE
trace, non-increasing within 0.1% an epoch, that ends below where it
began).  bfs takes [symmetrize]
[reverse] [source] and bc the same after the graph (src/bfs/main.cc:
8-19); sssp takes [symmetrize] [reverse] [source] [delta]; sgd [symmetrize] [-]
[lambda] [step] [max_iters]; kcl and motif [symmetrize] [k] (kcl: no
check past 5000 vertices at k > 3, motif: none past 80 vertices, as in
the reference's CLI); sgl [symmetrize] [pattern] (diamond, rectangle,
pentagon or house; no check past 40 vertices); fsm <minsup> <k> after the
graph, which it always symmetrizes (no check past 5000 vertices).
`main` returns 1 on 'Wrong'.
"""

from __future__ import annotations

import sys

import numpy as np

from gardenia_tpu_torch.core.graph import load_graph
from gardenia_tpu_torch.verify import (check, l2_error,
                                      maximum_relative_error, oracles)
from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.utils.report import gteps, report_runtime, spmv_bytes
from gardenia_tpu_torch.utils.timer import time_op


def _load(args, symmetrize_default=False, need_reverse=False):
    """(the Graph named by <filetype> <prefix|scale> [symmetrize], the
    positionals after them); each run_* function picks the symmetrize
    default and whether the reverse view is built (the pull sweeps read
    in-edges)."""
    filetype, prefix = args[0], args[1]
    symmetrize = bool(int(args[2])) if len(args) > 2 else symmetrize_default
    if filetype in ("rmat", "uniform"):
        # GAP-style synthetic graphs: prefix is the scale
        from gardenia_tpu_torch.core.generate import generate_graph
        g = generate_graph(filetype, scale=int(prefix),
                           symmetrize=symmetrize or symmetrize_default,
                           need_reverse=need_reverse)
    else:
        g = load_graph(prefix, filetype, symmetrize=symmetrize,
                       need_reverse=need_reverse)
    print(f"|V| {g.m} |E| {g.nnz}")
    return g, args[3:]


def run_pr(args, device, variant="pull") -> bool:
    print("PageRank by gardenia_tpu_torch")
    g, _ = _load(args, need_reverse=True)
    from gardenia_tpu_torch.solvers.pr import (EPSILON, pr_print_trace,
                                               pr_solver)
    res, secs = time_op(lambda: pr_solver(g, variant=variant, device=device),
                        device=device)
    pr_print_trace(res)
    report_runtime(variant, secs)
    print(f"GTEPS = {gteps(g.nnz, secs, res.iterations):.4f}")
    resid = oracles.pagerank_push_residual(g, res.scores.cpu().numpy())
    return check(resid < EPSILON, f"(residual {resid})")


def run_tc(args, device, variant="base") -> bool:
    """tc <filetype> <graph> (src/tc/main.cc:5-9): symmetrizes by default
    and applies the DAG orientation itself.  'base' is the rotate solver,
    as in the reference's CLI."""
    print("Triangle Counting by gardenia_tpu_torch")
    print("Using DAG (static orientation)")
    g, _ = _load(args, symmetrize_default=True)
    from gardenia_tpu_torch.solvers.tc import tc_solver
    solver_variant = "rotate" if variant == "base" else variant
    total, secs = time_op(lambda: tc_solver(g, variant=solver_variant,
                                            device=device), device=device)
    print(f"runtime [{variant}] = {secs:f} sec")
    print(f"total_num_triangles = {total}")
    expect = oracles.tc_serial(g.oriented())
    return check(total == expect, f"(expected {expect})")


def same_components(comp, expect) -> bool:
    """The bijection check of gardenia_tpu/cli.py run_cc: no expected
    component split across labels, and as many labels as components (a
    solver that merges components must fail)."""
    _, inv_a = np.unique(comp, return_inverse=True)
    _, inv_b = np.unique(expect, return_inverse=True)
    return (len(np.unique(inv_a * (inv_b.max() + 1) + inv_b)) ==
            len(np.unique(inv_b))
            and len(np.unique(inv_a)) == len(np.unique(inv_b)))


def run_cc(args, device, variant="sv") -> bool:
    """cc <filetype> <graph> (src/cc/main.cc): symmetrizes by default;
    Shiloach-Vishkin, as the reference CLI runs it."""
    print("Connected Components by gardenia_tpu_torch")
    g, _ = _load(args, symmetrize_default=True, need_reverse=True)
    from gardenia_tpu_torch.solvers.cc import cc_solver
    res, secs = time_op(lambda: cc_solver(g, variant=variant, device=device),
                        device=device)
    report_runtime(variant, secs)
    comp = res.comp.cpu().numpy()
    print(f"num_components = {len(np.unique(comp))}")
    return check(same_components(comp, oracles.cc_serial(g)))


def run_bfs(args, device, variant="pull") -> bool:
    """bfs <filetype> <prefix> [symmetrize] [reverse] [source]
    (src/bfs/main.cc:8-19)."""
    print("Breadth-first Search by gardenia_tpu_torch")
    g, rest = _load(args, need_reverse=True)
    source = int(rest[1]) if len(rest) > 1 else 0
    from gardenia_tpu_torch.solvers.bfs import bfs_solver
    res, secs = time_op(lambda: bfs_solver(g, source, variant=variant,
                                           device=device), device=device)
    print(f"\titerations = {res.iterations}.")
    report_runtime(variant, secs)
    print(f"GTEPS = {gteps(g.nnz, secs):.4f}")
    expect = oracles.bfs_serial(g, source)
    return check(bool((res.dist.cpu().numpy() == expect).all()))


def bc_close(scores, expect) -> bool:
    """The tolerance of the reference CLI's BC check: 1e-4 relative to
    |a| + |b| plus 1e-4 absolute, on scores normalized to a max of 1."""
    scores, expect = np.asarray(scores), np.asarray(expect)
    tol = 1e-4 * (np.abs(scores) + np.abs(expect)) + 1e-4
    return bool((np.abs(scores - expect) <= tol).all())


def run_bc(args, device, variant="base") -> bool:
    if variant != "base":
        raise ValueError(f"unknown bc variant {variant!r} (only 'base')")
    print("Betweenness Centrality by gardenia_tpu_torch")
    g, rest = _load(args, need_reverse=True)
    source = int(rest[1]) if len(rest) > 1 else 0
    from gardenia_tpu_torch.solvers.bc import bc_solver
    res, secs = time_op(lambda: bc_solver(g, source, device=device),
                        device=device)
    print(f"\titerations = {res.iterations}.")
    report_runtime(variant, secs)
    return check(bc_close(res.scores.cpu().numpy(),
                          oracles.bc_serial(g, source)))


def run_spmv(args, device, variant="ell") -> bool:
    """spmv <filetype> <graph> [symmetrize]: y = A x with the graph's
    weights, or 0.2 where it has none, and x = 0.3, against the serial
    product within sqrt(eps) of f32 (max relative error)."""
    print("Sparse Matrix-Vector Multiplication by gardenia_tpu_torch")
    g, _ = _load(args)
    from gardenia_tpu_torch.solvers.spmv import spmv_solver
    Ax = np.full(g.nnz, 0.2, np.float32) if g.weights is None \
        else np.asarray(g.weights, np.float32)
    x = np.full(g.n, 0.3, np.float32)
    y, secs = time_op(lambda: spmv_solver(g, Ax, x, variant=variant,
                                          device=device), device=device)
    gf = (2 * g.nnz / secs) / 1e9 if secs else 0
    gb = spmv_bytes(g.m, g.nnz) / secs / 1e9 if secs else 0
    report_runtime(variant, secs, gflops=gf, gbytes=gb)
    err = maximum_relative_error(y.cpu().numpy(),
                                 oracles.spmv_serial(g, Ax, x))
    return check(err < np.sqrt(np.finfo(np.float32).eps),
                 f"(max rel err {err})")


def run_sssp(args, device, variant="delta") -> bool:
    """sssp <filetype> <graph> [symmetrize] [reverse] [source] [delta]:
    distances equal to the serial Dijkstra's."""
    print("Single Source Shortest Path by gardenia_tpu_torch")
    g, rest = _load(args, need_reverse=True)
    source = int(rest[1]) if len(rest) > 1 else 0
    delta = int(rest[2]) if len(rest) > 2 else 1
    from gardenia_tpu_torch.solvers.sssp import sssp_solver
    res, secs = time_op(lambda: sssp_solver(g, source, delta,
                                            variant=variant, device=device),
                        device=device)
    print(f"\titerations = {res.iterations}.")
    report_runtime(variant, secs)
    expect = oracles.sssp_serial(g, source)
    return check(bool((res.dist.cpu().numpy() == expect).all()))


def run_scc(args, device, variant="color") -> bool:
    """scc <filetype> <graph> [symmetrize]: --variant=color (max-id FB
    colouring, base.cu) or --variant=wcc (WCC-first, wcc.cu /
    two_phase.cu); the components a bijection of the serial Tarjan's."""
    print("Strongly Connected Components by gardenia_tpu_torch")
    g, _ = _load(args)
    from gardenia_tpu_torch.solvers.scc import scc_solver
    res, secs = time_op(lambda: scc_solver(g, variant=variant,
                                           device=device), device=device)
    report_runtime(variant, secs)
    root = res.scc_root.cpu().numpy()
    print(f"number of SCCs = {len(np.unique(root))}")
    return check(same_components(root, oracles.scc_serial(g)))


def run_mst(args, device, variant="boruvka") -> bool:
    """mst <filetype> <graph>: symmetrizes by default; the tree weight
    within 1e-3 relative of Kruskal's."""
    if variant != "boruvka":
        raise ValueError(f"unknown mst variant {variant!r} (only "
                         f"'boruvka')")
    print("Minimum Spanning Tree by gardenia_tpu_torch")
    g, _ = _load(args, symmetrize_default=True)
    from gardenia_tpu_torch.solvers.mst import mst_solver
    res, secs = time_op(lambda: mst_solver(g, device=device), device=device)
    report_runtime(variant, secs)
    print(f"MST weight = {res.total_weight}")
    expect = oracles.mst_total_weight(g)
    return check(abs(res.total_weight - expect) < 1e-3 * max(1.0, expect),
                 f"(expected {expect})")


def run_vc(args, device, variant="base") -> bool:
    """vc <filetype> <graph>: symmetrizes by default; a proper colouring."""
    if variant != "base":
        raise ValueError(f"unknown vc variant {variant!r} (only 'base')")
    print("Vertex Coloring by gardenia_tpu_torch")
    g, _ = _load(args, symmetrize_default=True)
    from gardenia_tpu_torch.solvers.vc import vc_solver
    res, secs = time_op(lambda: vc_solver(g, device=device), device=device)
    print(f"\truntime [{variant}] = {secs * 1e3:f} ms, "
          f"num_colors = {res.num_colors}.")
    return check(oracles.vc_check(g, res.colors.cpu().numpy()))


def run_symgs(args, device, variant="base") -> bool:
    """symgs <filetype> <graph>: symmetrizes by default; Ax, x and b from
    default_rng(13), diag = degree + 1, the port's colouring (untimed);
    l2 error < 1e-4 against the serial sweep over the same colour blocks."""
    if variant != "base":
        raise ValueError(f"unknown symgs variant {variant!r} (only 'base')")
    print("Symmetric Gauss-Seidel smoother by gardenia_tpu_torch")
    g, _ = _load(args, symmetrize_default=True)
    from gardenia_tpu_torch.solvers.symgs import default_inputs, symgs_solver
    Ax, x0, b, diag, colors = default_inputs(g, device)
    res, secs = time_op(lambda: symgs_solver(g, Ax, x0, b, diag, colors,
                                             device=device), device=device)
    report_runtime(variant, secs)
    order = np.argsort(colors, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(colors))])
    expect = oracles.symgs_serial(g, order, Ax, diag, x0, b, offsets)
    err = l2_error(res.x.cpu().numpy(), expect)
    return check(err < 1e-4, f"(l2 err {err})")


def run_sgd(args, device, variant="base") -> bool:
    """sgd <filetype> <graph> [symmetrize] [-] [lambda] [step] [max_iters]:
    the RMSE trace finite, non-increasing within 0.1% an epoch (stochastic
    batches), and strictly lower at the end than after the first epoch."""
    if variant != "base":
        raise ValueError(f"unknown sgd variant {variant!r} (only 'base')")
    print("Stochastic Gradient Descent by gardenia_tpu_torch")
    g, rest = _load(args)
    lam = float(rest[1]) if len(rest) > 1 else 0.05
    step = float(rest[2]) if len(rest) > 2 else 0.003
    max_iters = int(rest[3]) if len(rest) > 3 else 3
    from gardenia_tpu_torch.solvers.sgd import sgd_solver
    res, secs = time_op(lambda: sgd_solver(g, lam, step, max_iters,
                                           epsilon=0.0, device=device),
                        device=device)
    trace = res.rmse.cpu().numpy()[:res.iterations]
    for i, e in enumerate(trace):
        print(f"Iteration {i + 1}: RMSE error = {e:f}")
    print(f"\titerations = {res.iterations}.")
    report_runtime(variant, secs)
    return check(sgd_trace_ok(trace))


def sgd_trace_ok(trace) -> bool:
    """The CLI's quality bar (gardenia_tpu/cli.py:241-250): finite,
    non-increasing within 0.1% an epoch, and a strict net decrease."""
    trace = np.asarray(trace)
    return bool(len(trace) and np.isfinite(trace).all()
                and (trace[1:] <= trace[:-1] * 1.001).all()
                and trace[-1] < trace[0])


def run_kcl(args, device, variant="base") -> bool:
    """kcl <filetype> <graph> [symmetrize] [k] (mining/kcl_dfs driver):
    symmetrizes by default, k = 4 by default; checked against the serial
    DFS when |V| <= 5000, and at k = 3 (the triangle route) through the
    expansion's own route (force_expand) on larger graphs."""
    if variant != "base":
        raise ValueError(f"unknown kcl variant {variant!r} (only 'base')")
    print("k-Clique Listing by gardenia_tpu_torch")
    g, rest = _load(args, symmetrize_default=True)
    k = int(rest[0]) if rest else 4
    from gardenia_tpu_torch.mining import kcl
    from gardenia_tpu_torch.ops import kcl_count
    before = kcl_count.LAUNCHES
    total, secs = time_op(lambda: kcl.kcl_solver(g, k, device=device),
                          device=device)
    report_runtime(variant, secs)
    print(f"total_num_cliques = {total}")
    print(f"route = {kcl.LAST_ROUTE}, Q1 launches = "
          f"{kcl_count.LAUNCHES - before}")
    if g.m <= 5000:
        return check(total == kcl.kcl_verifier(g, k))
    if k == 3:
        # the triangle count rode tc_solver: count again through Q1 or the
        # expansion, two independent implementations
        expect = kcl.kcl_solver(g, 3, force_expand=True, device=device)
        return check(total == expect, f"(route {kcl.LAST_ROUTE}: {expect})")
    print("(verification skipped: graph too large for serial oracle)")
    return True


def run_motif(args, device, variant="formula") -> bool:
    """motif <filetype> <graph> [symmetrize] [k]: the induced k-census
    (k = 3 by default, or 4) by the formula variant; checked against the
    brute-force census when |V| <= 80."""
    if variant != "formula":
        raise ValueError(f"unknown motif variant {variant!r} "
                         "(only 'formula')")
    print("Motif Counting by gardenia_tpu_torch")
    g, rest = _load(args, symmetrize_default=True)
    k = int(rest[0]) if rest else 3
    from gardenia_tpu_torch.mining import motif
    census, secs = time_op(lambda: motif.motif_solver(g, k, device=device),
                           device=device)
    report_runtime(variant, secs)
    for name, cnt in census.items():
        print(f"{name}: {cnt}")
    if k == 4:
        print(f"aggregates = {motif.LAST_AGGREGATES['aggregates']}")
    if g.m <= 80:
        return check(census == motif.motif_census_bruteforce(g, k))
    print("(verification skipped: graph too large for brute force)")
    return True


def run_sgl(args, device, variant="base") -> bool:
    """sgl <filetype> <graph> [symmetrize] [pattern] (mining/sgl/main.cc):
    symmetrizes by default, diamond by default; checked against the
    brute-force listing when |V| <= 40."""
    if variant != "base":
        raise ValueError(f"unknown sgl variant {variant!r} (only 'base')")
    print("Subgraph Listing by gardenia_tpu_torch")
    g, rest = _load(args, symmetrize_default=True)
    pattern = rest[0] if rest else "diamond"
    from gardenia_tpu_torch.mining import sgl
    total, secs = time_op(lambda: sgl.sgl_solver(g, pattern, device=device),
                          device=device)
    report_runtime(variant, secs)
    print(f"total_num_{pattern} = {total}")
    if g.m <= 40:
        return check(total == sgl.sgl_verifier(g, pattern))
    print("(verification skipped: graph too large for brute force)")
    return True


def run_fsm(args, device, variant="base") -> bool:
    """fsm <filetype> <graph> <minsup> <k> (mining/fsm/main.cc:9-11):
    always symmetrized, minsup 2 and k 2 by default; checked against the
    brute-force miner when |V| <= 5000."""
    if variant != "base":
        raise ValueError(f"unknown fsm variant {variant!r} (only 'base')")
    print("Frequent Subgraph Mining by gardenia_tpu_torch")
    g, _ = _load(args[:2] + ["1"], symmetrize_default=True)
    minsup = int(args[2]) if len(args) > 2 else 2
    k = int(args[3]) if len(args) > 3 else 2
    print(f"minsup = {minsup}")
    print(f"k = {k}")
    from gardenia_tpu_torch.mining.fsm import fsm_solver, fsm_verifier
    total, secs = time_op(lambda: fsm_solver(g, k, minsup, device=device),
                          device=device)
    report_runtime(variant, secs)
    print(f"Number of frequent subgraphs (minsup={minsup}): {total}")
    if g.m <= 5000:
        return check(total == fsm_verifier(g, k, minsup))
    print("(verification skipped: graph too large for brute force)")
    return True


def run_dist(kernel, n, args, device) -> int:
    """<kernel> --dist=n (gardenia_tpu/cli.py:341-383): pr, bfs, tc, vc
    and scc on n ranks, each checked as its single-device run is."""
    from gardenia_tpu_torch import parallel
    g, rest = _load(args, symmetrize_default=kernel in ("vc", "tc"),
                    need_reverse=kernel in ("pr", "bfs"))
    source = int(rest[1]) if kernel == "bfs" and len(rest) > 1 else 0
    solver = getattr(parallel, f"{kernel}_solver_dist")
    call = (solver, (g, source) if kernel == "bfs" else (g,), {})
    (res, secs), = parallel.run_on_ranks(parallel.time_each, n, str(device),
                                         [call])[0]
    print(f"mesh: {parallel.describe(n, device)}")
    report_runtime(f"{kernel}_dist{n}", secs)
    if kernel == "pr":
        resid = oracles.pagerank_push_residual(g, res.scores.numpy())
        ok = check(resid < 1e-4, f"(residual {resid})")
    elif kernel == "bfs":
        ok = check(bool((res.dist.numpy() ==
                         oracles.bfs_serial(g, source)).all()))
    elif kernel == "tc":
        print(f"total_num_triangles = {res}")
        expect = oracles.tc_serial(g.oriented())
        ok = check(res == expect, f"(expected {expect})")
    elif kernel == "vc":
        print(f"num_colors = {res.num_colors}")
        ok = check(oracles.vc_check(g, res.colors.numpy()))
    else:
        root = res.scc_root.numpy()
        print(f"number of SCCs = {len(np.unique(root))}")
        ok = check(same_components(root, oracles.scc_serial(g)))
    return 0 if ok else 1


DIST_KERNELS = ("pr", "bfs", "tc", "vc", "scc")

KERNELS = {"pr": run_pr, "spmv": run_spmv, "bfs": run_bfs,
           "sssp": run_sssp, "cc": run_cc, "bc": run_bc, "tc": run_tc,
           "scc": run_scc, "mst": run_mst, "vc": run_vc,
           "symgs": run_symgs, "sgd": run_sgd, "kcl": run_kcl,
           "motif": run_motif, "sgl": run_sgl, "fsm": run_fsm}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in KERNELS:
        print("Usage: python -m gardenia_tpu_torch.cli <kernel> <filetype> "
              "<graph-prefix|scale> [kernel args...] [--variant=NAME] "
              "[--device={cuda,cpu}] [--dist=N]\n"
              f"kernels: {' '.join(sorted(KERNELS))}")
        return 1
    kernel = argv[0]
    # flags may stand anywhere among the positionals (the reference
    # binaries are purely positional; the flags are this CLI's)
    variant, device_name, dist = None, "cuda", None
    rest = []
    words = iter(argv[1:])
    for word in words:
        if not word.startswith("--"):
            rest.append(word)
        elif word.startswith("--variant="):
            variant = word.split("=", 1)[1]
        elif word.startswith("--device="):
            device_name = word.split("=", 1)[1]
        elif word == "--device":
            device_name = next(words, "")
        elif word.startswith("--dist="):
            dist = word.split("=", 1)[1]
            if not dist.isdigit() or int(dist) < 1:
                print(f"--dist takes a number of ranks, got {dist!r}")
                return 1
            dist = int(dist)
        else:
            print(f"unknown flag {word!r}")
            return 1
    if device_name not in ("cuda", "cpu"):
        print(f"unknown device {device_name!r} (cuda or cpu)")
        return 1
    if len(rest) < 2:
        print("expected <filetype> <graph-prefix|scale> after the kernel")
        return 1
    if dist is not None and kernel not in DIST_KERNELS:
        print(f"kernel {kernel!r} has no multi-device path yet")
        return 1
    device = resolve_device(device_name)
    if dist is not None:
        if variant is not None:
            print(f"(--variant={variant} is ignored for --dist runs: "
                  f"the multichip solvers pick their own mapping)")
        return run_dist(kernel, dist, rest, device)
    kw = {} if variant is None else {"variant": variant}
    try:
        ok = KERNELS[kernel](rest, device, **kw)
    except ValueError as e:
        if variant is None or "variant" not in str(e):
            raise
        print(e)
        return 1
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
