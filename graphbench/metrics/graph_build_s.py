"""Seconds of the port's host graph build: core/graph.from_edges over
the raw edge list (native/csr_build.cpp: symmetrize, drop self-loops and
duplicates, CSR), on the host clock.  Moves setup_s."""


def read(run):
    return run["phases"].get("graph_build_s")
