"""Device kernels launched a trial: the kernel events of the traced
window (copies not counted) over its trials.  Reads the solvers' host
loops (solvers/pr, bfs, tc): each level, iteration or class is a run of
launches.  Moves trials_per_s."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr["trials"] or not tr["kernels"]:
        return None
    return tr["kernels"] / tr["trials"]
