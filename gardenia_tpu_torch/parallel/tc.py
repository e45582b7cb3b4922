"""Multi-device triangle counting: the wedge space split over the ranks —
the torch counterpart of gardenia_tpu/parallel/tc.py.

Each rank takes an equal slice of the DAG's wedge space (arc e = (u, v)
times slot k into N+(u)) and counts the closed ones with the same
enumeration as solvers/tc.tc_bsearch (ops/intersect.membership_counts);
the DAG's CSR is replicated, being read-only and far smaller than the
wedge space.  The partial counts are all-reduced as int64.  Wedge indices
are int64, so the reference's int32 guard and its one-hot row select
(`rowsel`, a TPU gather workaround) are not needed.
"""

from __future__ import annotations

from gardenia_tpu_torch.solvers.tc import count_wedges, wedge_index


def tc_solver_dist(g, *, mesh, chunk: int = 1 << 18) -> int:
    """The triangle count of symmetric g on every rank of mesh."""
    dag = g._dev(("oriented",), g.oriented)
    if dag.nnz == 0:
        return 0
    index = wedge_index(dag, mesh.device)
    total = index[4]
    per = -(-total // mesh.size)
    lo = min(total, mesh.rank * per)
    hi = min(total, lo + per)
    return int(mesh.all_reduce(count_wedges(index, lo, hi, chunk)))
