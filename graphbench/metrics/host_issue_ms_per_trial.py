"""The host's own milliseconds a trial: the traced window's time inside
the port's solve.* spans less the time inside their read spans, over its
trials.  Where it nears trial_ms_p50 the host sets the pace, where it is
small the card does.  Reads the solvers' host loops.  Moves
trials_per_s."""

from graphbench import spans


def read(run):
    if not spans.has_recorder(run) or not run["window"]["trials"]:
        return None
    return spans.length(spans.issuing(run)) / 1e6 / run["window"]["trials"]
