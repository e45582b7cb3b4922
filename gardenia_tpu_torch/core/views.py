"""Torch device views of the shared host Graph.

The host Graph (gardenia_tpu.core.graph) is jax-free and shared with the
reference package; its `ell`, `hybrid` and `device_*` methods import jax
and are never called here.  These functions build the port's views from
the Graph's numpy CSR instead and cache them in the same per-graph cache
(`Graph._dev`), under keys of their own: ("torch", kind, device, ...).
"""

from __future__ import annotations

import numpy as np
import torch

from gardenia_tpu.core import types as T


def _key(kind: str, device, *rest):
    return ("torch", kind, str(torch.device(device)), *rest)


def degrees(g, device) -> torch.Tensor:
    """i32[m] out-degrees."""
    return g._dev(_key("deg", device), lambda: torch.from_numpy(
        np.asarray(g.degrees, T.VID_DTYPE)).to(device))


def reverse_ell(g, device):
    """Unweighted ELL slab matrix of g's transpose (in-edges per row)."""
    def mk():
        from gardenia_tpu_torch.ops.ell import build_ell
        return build_ell(g.in_rowptr, g.in_colidx, None,
                         num_cols=g.n).to(device)
    return g._dev(_key("ell", device, "reverse"), mk)


def reverse_hybrid(g, device):
    """Unweighted hybrid block-sparse matrix (threshold 16) of g's
    transpose.  Build block locality first with gardenia_tpu.core.relabel
    on scatter-labelled graphs."""
    def mk():
        from gardenia_tpu_torch.ops.bsr import build_hybrid
        return build_hybrid(g.in_rowptr, g.in_colidx, None,
                            num_cols=g.n).to(device)
    return g._dev(_key("hybrid", device, "reverse"), mk)


def relabeled_hybrid(g, device):
    """(relabelled graph, its reverse hybrid matrix, new_of_old tensor) —
    the degree-relabelled layout that pull PageRank runs on."""
    from gardenia_tpu.core.relabel import relabeled
    rel = relabeled(g)
    hyb = reverse_hybrid(rel.graph, device)
    new_of_old = g._dev(_key("new_of_old", device), lambda: torch.from_numpy(
        np.asarray(rel.new_of_old, np.int64)).to(device))
    return rel.graph, hyb, new_of_old
