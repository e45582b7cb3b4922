"""Share of the traced window in which the card was idle while the host
was inside a solve.* span and outside any read span: the idle that the
host's launch issue leaves.  Reads the solvers' host loops.  Moves
trials_per_s."""

from graphbench import spans


def read(run):
    if not spans.has_recorder(run):
        return None
    lo, hi = run["window"]["start_ns"], run["window"]["end_ns"]
    if hi <= lo:
        return None
    gaps = spans.intersect(spans.idle(run), spans.issuing(run))
    return 100.0 * spans.length(gaps) / (hi - lo)
