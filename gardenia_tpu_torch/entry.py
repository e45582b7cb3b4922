"""Entry points of the port — the twin of the repo's __graft_entry__.py.

entry(device)               -> (pr_step, example_args): one pull-PageRank
                               power iteration over the degree-relabelled
                               hybrid layout of the scale-10 graph, through
                               ops/bsr.spmv_hybrid (kernel K1 on a card).
dryrun_multichip(n, device) -> runs the 13 multi-device paths of
                               __graft_entry__.dryrun_multichip (SGD, PR,
                               BFS, SSSP, CC, BC, SpMV, data-parallel
                               multi-source BFS, VC, SymGS, MST, and the
                               2D mesh's TC and SCC) on n ranks and asserts
                               each against the single-device solver or
                               the serial oracle, with its tolerances.

    python -m gardenia_tpu_torch.entry [n] [--device cuda|cpu]

runs entry()'s step once and dryrun_multichip(n) (n = 2 by default).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from gardenia_tpu_torch import resolve_device


def _tiny_graph(need_reverse: bool):
    """R-MAT-10, degree 8, symmetrized (__graft_entry__.py:17-25)."""
    from gardenia_tpu_torch.core.generate import generate_graph
    return generate_graph("rmat", scale=10, degree=8, symmetrize=True,
                          need_reverse=need_reverse)


def entry(device="cuda"):
    """(pr_step, (scores0,)): pr_step(scores) = 0.15 / m + 0.85 *
    A^T (scores / out-degree) over the relabelled hybrid layout, on
    `device`."""
    import torch
    from gardenia_tpu_torch.core import views
    from gardenia_tpu_torch.ops.bsr import spmv_hybrid

    dev = resolve_device(device)
    g = _tiny_graph(need_reverse=True)
    g2, hyb, _ = views.relabeled_hybrid(g, dev)
    deg = views.degrees(g2, dev).float().clamp(min=1.0)
    m = g2.m
    base = float(np.float32(0.15 / m))

    def pr_step(scores):
        return base + float(np.float32(0.85)) * spmv_hybrid(
            hyb, scores / deg, num_rows=m)

    example_args = (torch.full((m,), float(np.float32(1.0 / m)),
                               dtype=torch.float32, device=dev),)
    return pr_step, example_args


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what} differ(s) from the "
                             "reference")


def _symgs_on_vc_colours(g, ax, x, b, diag, *, mesh):
    """(vc_solver_dist's colouring, symgs_solver_dist on it), as the JAX
    dryrun feeds the distributed colouring to SymGS."""
    from gardenia_tpu_torch import parallel as P
    colors = P.vc_solver_dist(g, mesh=mesh).colors.cpu().numpy()
    return colors, P.symgs_solver_dist(g, ax, x, b, diag, colors, mesh=mesh)


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Run the JAX dryrun's 13 multi-device paths on n ranks on `device`
    in one group and assert each: SGD's step against sgd_solver's
    full-batch step (rtol 2e-5, atol 1e-7); PR (3 iterations) against
    pr_solver within 1e-6 with the same iterations; BFS, SSSP and every
    multi-source column equal to the serial oracle; CC and the 2D SCC the
    serial components; BC (hybrid) against bc_batched within 1e-5; SpMV
    against the serial product (rtol 2e-5, atol 1e-6); VC a proper
    colouring; SymGS on it against symgs_solver (rtol 1e-4, atol 1e-5);
    MST's weight equal to mst_solver's; the 2D TC equal to the serial
    count.  Prints and returns the OK line, which names the 2D mesh."""
    from gardenia_tpu_torch import parallel as P
    from gardenia_tpu_torch.cli import same_components
    from gardenia_tpu_torch.bench import mst_graph
    from gardenia_tpu_torch.parallel.mesh import mesh2d_shape
    from gardenia_tpu_torch.solvers.bc import bc_batched
    from gardenia_tpu_torch.solvers.mst import mst_solver
    from gardenia_tpu_torch.solvers.pr import pr_solver
    from gardenia_tpu_torch.solvers.sgd import sgd_solver
    from gardenia_tpu_torch.solvers.symgs import symgs_solver
    from gardenia_tpu_torch.verify import oracles

    dev = resolve_device(device)
    gw = _tiny_graph(need_reverse=False)
    g = _tiny_graph(need_reverse=True)
    srcs = np.arange(2 * n_devices) % g.m
    rng = np.random.default_rng(7)
    sg_in = (rng.random(g.nnz).astype(np.float32),
             rng.random(g.m).astype(np.float32),
             rng.random(g.m).astype(np.float32),
             (g.degrees + 1).astype(np.float32))
    gm = mst_graph(g)          # the JAX dryrun's hashed weights, 1..97
    calls = {"sgd": (P.sgd_train_dist, (gw,), {"iters": 1}),
             "pr": (P.pr_solver_dist, (g,), {"max_iter": 3}),
             "bfs": (P.bfs_solver_dist, (g, 0), {}),
             "sssp": (P.sssp_solver_dist, (g, 0), {}),
             "cc": (P.cc_solver_dist, (g,), {}),
             "bc": (P.bc_batched_dist, (g, srcs), {"layout": "hybrid"}),
             "spmv": (P.spmv_solver_dist, (g,), {}),
             "msbfs-dp": (P.bfs_multi_source_dist, (g, srcs), {}),
             "vc": (_symgs_on_vc_colours, (g, *sg_in), {}),
             "mst": (P.mst_solver_dist, (gm,), {}),
             "tc2d": (P.tc_solver_dist2d, (g,), {}),
             "scc2d": (P.scc_solver_dist2d, (g,), {})}
    got = dict(zip(calls, P.run_on_ranks(P.call_each, n_devices, str(dev),
                                         list(calls.values()))[0]))
    ok = []
    sgd, sgd_s = got["sgd"], sgd_solver(gw, max_iters=1, epsilon=0.0,
                                        device=dev)
    np.testing.assert_allclose(sgd.user_lv.numpy(),
                               sgd_s.user_lv.cpu().numpy(), rtol=2e-5,
                               atol=1e-7)
    ok.append("sgd")
    res, res_s = got["pr"], pr_solver(g, max_iter=3, device=dev)
    _require(res.iterations == res_s.iterations, "pr's iterations")
    np.testing.assert_allclose(res.scores.numpy(),
                               res_s.scores.cpu().numpy(), atol=1e-6)
    ok.append("pr")
    np.testing.assert_array_equal(got["bfs"].dist.numpy(),
                                  oracles.bfs_serial(g, 0))
    ok.append("bfs")
    np.testing.assert_array_equal(got["sssp"].dist.numpy(),
                                  oracles.sssp_serial(g, 0))
    ok.append("sssp")
    _require(same_components(got["cc"].comp.numpy(), oracles.cc_serial(g)),
             "cc's components")
    ok.append("cc")
    np.testing.assert_allclose(
        got["bc"].scores.numpy(),
        bc_batched(g, srcs, device=dev).scores.cpu().numpy(), atol=1e-5)
    ok.append("bc")
    np.testing.assert_allclose(
        got["spmv"].numpy(),
        oracles.spmv_serial(g, np.full(g.nnz, 0.2, np.float32),
                            np.full(g.n, 0.3, np.float32)),
        rtol=2e-5, atol=1e-6)
    ok.append("spmv")
    msb = got["msbfs-dp"].dist.numpy()
    _require(msb.shape == (g.m, len(srcs)), "msbfs-dp's shape")
    for j, s in enumerate(srcs):
        np.testing.assert_array_equal(msb[:, j], oracles.bfs_serial(g, int(s)))
    ok.append("msbfs-dp")
    colors, sgs = got["vc"]
    _require(oracles.vc_check(g, colors), "vc's colouring")
    ok.append("vc")
    np.testing.assert_allclose(
        sgs.x.numpy(), symgs_solver(g, *sg_in, colors, device=dev).x.cpu()
        .numpy(), rtol=1e-4, atol=1e-5)
    ok.append("symgs")
    _require(got["mst"].total_weight == mst_solver(gm, device=dev)
             .total_weight, "mst's weight")
    ok.append("mst")
    tc = got["tc2d"]
    _require(tc == oracles.tc_serial(g.oriented()), "tc2d's count")
    ok.append("tc2d")
    _require(same_components(got["scc2d"].scc_root.numpy(),
                             oracles.scc_serial(g)), "scc2d's components")
    ok.append("scc2d")
    r, c = mesh2d_shape(n_devices)
    line = (f"dryrun_multichip OK: {P.describe(n_devices, dev)} ({r}x{c} "
            f"2D), kernels {'+'.join(ok)}, sgd rmse={float(sgd.rmse):.4f}, "
            f"pr {res.iterations} iters, tc={tc}")
    print(line)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gardenia_tpu_torch.entry")
    ap.add_argument("n", type=int, nargs="?", default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    fn, (scores,) = entry(args.device)
    print(f"entry: pr_step over {scores.shape[0]} vertices, sum "
          f"{float(fn(scores).sum()):.6f}")
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
