"""Share of the PR trial's device busy time that the graph's own bytes
need at the card's published HBM rate: the least time over the time
taken.  Reads the kernels of the PR apply (ops/bsr.spmv_hybrid: K1 and
ops/spmv.spmv_ell), whatever layout implements it.  Moves trials_per_s.

Bytes an iteration: each arc's 4-byte column id once, and the float32
rank vector read once and written once (4 B + 4 B a vertex).  The
iterations are the reference's at the same epsilon.  Not the port's
layout: a layout change leaves this count as it is."""


def iteration_bytes(vertices: int, arcs: int) -> int:
    return 4 * arcs + 8 * vertices


def trial_bytes(vertices: int, arcs: int, iterations: int) -> int:
    return iterations * iteration_bytes(vertices, arcs)


def read(run):
    tr, peaks = run.get("trace"), run.get("peaks")
    its = run.get("reference", {}).get("pr_iterations")
    if not tr or not peaks or not its or tr["busy_s"] <= 0 \
            or not tr["trials"]:
        return None
    g = run["graph"]
    least_s = trial_bytes(g["vertices"], g["arcs"], its) \
        / peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (tr["busy_s"] / tr["trials"])
