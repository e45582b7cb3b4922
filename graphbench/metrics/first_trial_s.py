"""Seconds of the first trial, which builds what the solver caches on
the graph (core/relabel, ops/bsr.build_hybrid and ops/ell.build_ell
through core/views, solvers/tc.tc_prep) and uploads it, then solves; on
the host clock up to torch.cuda.synchronize().  Moves setup_s."""


def read(run):
    return run["phases"].get("first_trial_s")
