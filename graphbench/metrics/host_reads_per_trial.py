"""Device-to-host reads a trial: the port's host_reads counter over the
traced window (utils/profiler.host_read: one a PR iteration, one a BFS
level and one more, one a TC count), over its trials.  Reads the
solvers' host loops: each read waits for the card.  Moves trials_per_s."""

from graphbench import spans


def read(run):
    if not spans.has_recorder(run) or not run["window"]["trials"]:
        return None
    return run["counters"]["window"].get("host_reads", 0) \
        / run["window"]["trials"]
