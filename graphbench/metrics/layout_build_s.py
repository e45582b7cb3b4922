"""Seconds of the port's layout builds before the window: the outermost
layout.* spans (core/graph.Graph._dev's misses: the relabel, the hybrid
and ELL builds, TC's prep, the uploads) of set-up.  Moves setup_s."""

from graphbench import spans


def read(run):
    if not spans.has_recorder(run):
        return None
    return spans.before_window_s(run, "layout.") or 0.0
