"""Share of the SymGS trial's device busy time that the matrix's own bytes
need at the card's published HBM rate: the least time over the time
taken.  Reads the kernels of the sweep (solvers/symgs.sweep: the gather of
x, the product, the segment sum, the row update), whatever layout
implements them.  Moves trials_per_s.

Bytes a trial: each half of the application (forward, backward) reads
every arc's column id and value (4 B + 4 B) and every row's b and
diagonal (4 B + 4 B), and reads and writes x (4 B + 4 B).  The arcs and
vertices are the reference's graph's, so a change of the port's layout or
colouring leaves this count as it is."""


def trial_bytes(vertices: int, arcs: int) -> int:
    return 2 * (8 * arcs + 16 * vertices)


def read(run):
    tr, peaks = run.get("trace"), run.get("peaks")
    if not tr or not peaks or tr["busy_s"] <= 0 or not tr["trials"]:
        return None
    g = run["graph"]
    least_s = trial_bytes(g["vertices"], g["arcs"]) / peaks["hbm_bytes_per_s"]
    return 100.0 * least_s / (tr["busy_s"] / tr["trials"])
