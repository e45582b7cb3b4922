"""Share of the SSSP trial's device busy time that the graph's own bytes
need at the card's published HBM rate: the least time over the time
taken.  Reads the kernels of the SSSP relax (solvers/sssp.Relaxer:
ops/frontier's expansion and the scatter-min, ops/spmv.spmv_ell's
min-plus sweep), whatever layout implements them.  Moves trials_per_s.

Bytes a trial: each arc out of a reached vertex once, its 4-byte column
id and its 4-byte int32 weight, and the int32 distances read once and
written once (4 B + 4 B a vertex).  The reached arcs are the reference's
(kernels/sssp.py's check, the mean over the sampled sources).  Not the
port's layout or its rounds: a change to either leaves this count as it
is."""


def trial_bytes(vertices: int, reached_arcs: float) -> float:
    return 8 * reached_arcs + 8 * vertices


def read(run):
    tr, peaks = run.get("trace"), run.get("peaks")
    arcs = run.get("reference", {}).get("reached_arcs")
    if not tr or not peaks or not arcs or tr["busy_s"] <= 0 \
            or not tr["trials"]:
        return None
    least_s = trial_bytes(run["graph"]["vertices"], arcs) \
        / peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (tr["busy_s"] / tr["trials"])
