"""GAP-style getopt flag parsing — the port's copy of
gardenia_tpu/core/command_line.py, parity with the reference's GAP port
(include/command_line.h:26-248: CLBase/CLApp/CLPageRank/CLDelta flag
classes, used by the GAP-derived mining mains).

Flags (command_line.h:38-56):
  -f <file>   load graph from file
  -g <scale>  synthetic Kronecker (R-MAT) graph, 2^scale vertices
  -u <scale>  synthetic uniform-random graph
  -k <degree> average degree for synthetic graphs (default 16)
  -s          symmetrize the graph
  -n <n>      number of trials
  -r <node>   start/source vertex
  -i <n>      max iterations (CLPageRank / CLIterApp)
  -t <tol>    tolerance (CLPageRank)
  -d <delta>  delta parameter (CLDelta / SSSP)
"""

from __future__ import annotations

import getopt
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class GapFlags:
    filename: Optional[str] = None
    scale: Optional[int] = None
    uniform: bool = False
    degree: int = 16
    symmetrize: bool = False
    num_trials: int = 1
    start_vertex: int = 0
    max_iters: Optional[int] = None
    tolerance: Optional[float] = None
    delta: int = 1
    extra: list = field(default_factory=list)


def parse_gap_args(argv) -> GapFlags:
    """Parse GAP-style flags (raises getopt.GetoptError on bad input)."""
    opts, rest = getopt.getopt(argv, "f:g:u:k:sn:r:i:t:d:h")
    fl = GapFlags(extra=list(rest))
    for o, a in opts:
        if o == "-f":
            fl.filename = a
        elif o == "-g":
            fl.scale = int(a)
        elif o == "-u":
            fl.scale = int(a)
            fl.uniform = True
        elif o == "-k":
            fl.degree = int(a)
        elif o == "-s":
            fl.symmetrize = True
        elif o == "-n":
            fl.num_trials = int(a)
        elif o == "-r":
            fl.start_vertex = int(a)
        elif o == "-i":
            fl.max_iters = int(a)
        elif o == "-t":
            fl.tolerance = float(a)
        elif o == "-d":
            fl.delta = int(a)
        elif o == "-h":
            print(__doc__)
    return fl


def load_from_flags(fl: GapFlags, need_reverse: bool = False):
    """Materialize the graph a GAP main would build (builder.h:258
    MakeGraph: file if -f, else synthetic per -g/-u)."""
    if fl.filename:
        from gardenia_tpu_torch.core.graph import load_graph
        return load_graph(fl.filename, "auto", symmetrize=fl.symmetrize,
                          need_reverse=need_reverse)
    if fl.scale is None:
        raise ValueError("need -f <file> or -g/-u <scale>")
    from gardenia_tpu_torch.core.generate import generate_graph
    return generate_graph("uniform" if fl.uniform else "rmat",
                          scale=fl.scale, degree=fl.degree,
                          symmetrize=fl.symmetrize,
                          need_reverse=need_reverse)
