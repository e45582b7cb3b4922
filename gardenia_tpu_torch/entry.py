"""Entry points of the port — the twin of the repo's __graft_entry__.py.

entry(device)               -> (pr_step, example_args): one pull-PageRank
                               power iteration over the degree-relabelled
                               hybrid layout of the scale-10 graph, through
                               ops/bsr.spmv_hybrid (kernel K1 on a card).
dryrun_multichip(n, device) -> runs every multi-device path ported so far
                               (parallel/: PR, BFS, data-parallel
                               multi-source BFS, TC, VC, SCC) on n ranks
                               and asserts each against the single-device
                               solver or the serial oracle, as
                               __graft_entry__.dryrun_multichip does for
                               those kernels.

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


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Run every ported multi-device path on n ranks on `device` and
    assert it: PR (3 iterations) equal to pr_solver within 1e-6 with the
    same iterations, BFS and every multi-source column equal to the serial
    BFS, TC equal to the serial count, VC a proper colouring, SCC the
    serial SCCs.  Prints and returns the OK line."""
    from gardenia_tpu_torch import parallel as P
    from gardenia_tpu_torch.cli import same_components
    from gardenia_tpu_torch.solvers.pr import pr_solver
    from gardenia_tpu_torch.verify import oracles

    dev = resolve_device(device)
    g = _tiny_graph(need_reverse=True)
    msb_srcs = np.arange(2 * n_devices) % g.m
    calls = {"pr": (P.pr_solver_dist, (g,), {"max_iter": 3}),
             "bfs": (P.bfs_solver_dist, (g, 0), {}),
             "msbfs-dp": (P.bfs_multi_source_dist, (g, msb_srcs), {}),
             "tc": (P.tc_solver_dist, (g,), {}),
             "vc": (P.vc_solver_dist, (g,), {}),
             "scc": (P.scc_solver_dist, (g,), {})}
    got = dict(zip(calls, P.run_on_ranks(P.call_each, n_devices, str(dev),
                                         list(calls.values()))[0]))
    res, res_s = got["pr"], pr_solver(g, max_iter=3, device=dev)
    _require(res.iterations == res_s.iterations, "pr's iterations")
    np.testing.assert_allclose(res.scores.numpy(),
                               res_s.scores.cpu().numpy(), atol=1e-6)
    np.testing.assert_array_equal(got["bfs"].dist.numpy(),
                                  oracles.bfs_serial(g, 0))
    msb = got["msbfs-dp"].dist.numpy()
    _require(msb.shape == (g.m, len(msb_srcs)), "msbfs-dp's shape")
    for j, s in enumerate(msb_srcs):
        np.testing.assert_array_equal(msb[:, j], oracles.bfs_serial(g, int(s)))
    tc = got["tc"]
    _require(tc == oracles.tc_serial(g.oriented()), "tc's count")
    _require(oracles.vc_check(g, got["vc"].colors.numpy()), "vc's colouring")
    _require(same_components(got["scc"].scc_root.numpy(),
                            oracles.scc_serial(g)), "scc's components")
    line = (f"dryrun_multichip OK: {P.describe(n_devices, dev)}, kernels "
            f"{'+'.join(calls)}, pr {res.iterations} iters, tc={tc}")
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
