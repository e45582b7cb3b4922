"""Degree-sorted vertex relabeling — hub clustering for block locality.

The hybrid block-sparse layout (ops/bsr.py) needs hub vertices to share
128-aligned id blocks; scale-free generators and real datasets scatter
hubs across the id space (measured on RMAT-20: 21.7M occupied
128x128 blocks at 1.45 edges each natural, 3.1M at 10.2 after degree
sorting).  This is the TPU counterpart of the reference's locality
preprocessing intent in src/pr/tiling.cu / src/spmv/partition.cu
(column-range segmenting), done once on the host as a stable argsort.

new id i maps to the vertex of i-th largest total degree.  The result
Graph is cached on the source graph; `new_of_old` converts original ids
to relabeled ids and `old_of_new` the inverse.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from gardenia_tpu_torch.core import build
from gardenia_tpu_torch.core import types as T


class Relabeled(NamedTuple):
    graph: object                  # the relabeled Graph
    new_of_old: np.ndarray         # i32[m]: new id of original vertex
    old_of_new: np.ndarray         # i32[m]: original vertex of new id


def degree_relabel(g) -> Relabeled:
    """Relabel g's vertices by non-increasing total degree (stable).

    Weights, vertex labels and symmetry are carried over; the reverse
    view of the result is rebuilt lazily on demand.
    """
    from gardenia_tpu_torch.core.graph import Graph

    key = g.degrees.astype(np.int64)
    if not g.symmetric:
        key = key + g.in_degrees.astype(np.int64)
    old_of_new = np.argsort(-key, kind="stable").astype(T.VID_DTYPE)
    new_of_old = np.empty(g.m, T.VID_DTYPE)
    new_of_old[old_of_new] = np.arange(g.m, dtype=T.VID_DTYPE)

    src, dst = build.csr_to_coo(g.rowptr, g.colidx)
    s2 = new_of_old[src]
    d2 = new_of_old[dst]
    rp, ci, w = build.coo_to_csr(g.m, s2, d2, g.weights,
                                 sorted_by_src=False)
    vl = None if g.vlabels is None else np.asarray(g.vlabels)[old_of_new]
    g2 = Graph(rp, ci, w, num_cols=g.n, symmetric=g.symmetric, vlabels=vl)
    return Relabeled(g2, new_of_old, old_of_new)


def relabeled(g) -> Relabeled:
    """Cached degree_relabel of g."""
    return g._dev(("relabel_degree",), lambda: degree_relabel(g))
