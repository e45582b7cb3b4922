"""Seconds of the kernel library's load before the window: the
kernels.load span of ops/_build.lib() (nvcc where the sources' hash has
no library in the checkout, then the ctypes load); None in a run that
never loads it.  Moves setup_s."""

from graphbench import spans


def read(run):
    if not spans.has_recorder(run):
        return None
    return spans.before_window_s(run, "kernels.load")
