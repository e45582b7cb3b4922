"""Colours of the port's colouring (kernels/symgs.py's check: the sampled
answers' num_colors).  Reads the solvers' host loop (solvers/symgs): an
application sweeps two colour blocks a colour, each a run of launches,
so fewer colours are fewer host-issued blocks.  Moves trials_per_s."""


def read(run):
    return run.get("reference", {}).get("num_colors")
