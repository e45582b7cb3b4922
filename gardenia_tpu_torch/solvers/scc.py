"""SCC — strongly connected components by FB-Trim; torch counterpart of
gardenia_tpu/solvers/scc.py (reference src/scc/{scc.h,base.cu,
two_phase.cu,wcc.cu}).

Variants:
  'color' — per outer round: trim-1 and trim-2 (vertices with no active
            in- or out-edge are singleton SCCs; an isolated mutual pair
            is one of size 2), then forward max-id colour propagation
            (color[v] = the largest id that reaches v inside the active
            subgraph; O(diameter) sweeps), then one backward closure from
            every colour root within its colour: what it reaches is the
            root's SCC (base.cu's multi-pivot FB).
  'wcc'   — per outer round: trim, then a partition of the active
            subgraph into weakly connected components by hooking and
            pointer jumping (O(log m) sweeps), one pivot a component (its
            largest active id), forward and backward closures, SCC =
            both; the survivors are tagged by region (forward only,
            backward only, neither) so that the next round never joins
            across regions (wcc.cu, two_phase.cu).

The JAX solver nests lax.while_loops.  Here every loop runs on the host
and reads one flag a sweep: a trim pass (did it remove a vertex), a
colour or closure sweep (did anything change), an outer round (is a
vertex still active).  scatter-max and scatter-min are scatter_reduce_'s
amax and amin; the vertex labels equal the JAX solver's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import views
from gardenia_tpu_torch.utils.profiler import spanned

VARIANTS = ("color", "wcc")


@dataclasses.dataclass
class SCCResult:
    scc_root: torch.Tensor   # i32[m]: the pivot id of each vertex's SCC
    iterations: int          # outer FB rounds


def _scatter(m: int, idx, vals, fill, how: str) -> torch.Tensor:
    """An m-vector of `fill` with vals combined at idx by `how`
    ('amax' or 'amin'), `fill` included."""
    out = torch.full((m,), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, idx, vals, how)


def _reach(m: int, start, ea, frm, to):
    """Closure of `start` over the edges ea (frm -> to), one read a
    sweep."""
    reach = start
    changed = bool(start.any())
    while changed:
        x = (ea & reach[frm]).to(torch.int8)
        new = reach | (_scatter(m, to, x, 0, "amax") > 0)
        changed = bool((new != reach).any())
        reach = new
    return reach


def _trim(m, src, dst, vid, root, active):
    """Trim-1 and trim-2 passes until one removes nothing: (root, active)
    with every removed vertex labelled (scc.h:12, FB-Trim)."""
    while True:
        ea = active[src] & active[dst]
        ea_i = ea.to(torch.int32)
        ind = torch.zeros(m, dtype=torch.int32, device=src.device) \
            .index_add_(0, dst, ea_i)
        outd = torch.zeros(m, dtype=torch.int32, device=src.device) \
            .index_add_(0, src, ea_i)
        trivial = active & ((ind == 0) | (outd == 0))
        # an isolated 2-cycle u <-> v (each the other's only active
        # neighbour): its unique neighbour by a scatter-max over the
        # single active edge
        in_nbr = _scatter(m, dst, torch.where(ea, src.int(), -1), -1, "amax")
        out_nbr = _scatter(m, src, torch.where(ea, dst.int(), -1), -1,
                           "amax")
        cand = active & (ind == 1) & (outd == 1) & (in_nbr == out_nbr)
        v = out_nbr.clamp(0, m - 1).long()
        paired = cand & cand[v] & (out_nbr[v] == vid)
        root = torch.where(trivial, vid, root)
        root = torch.where(paired, torch.minimum(vid, out_nbr), root)
        removed = trivial | paired
        active = active & ~removed
        if not bool(removed.any()):
            return root, active


@spanned("solve.scc")
def scc_solver(g, *, max_rounds: int = None, variant: str = "color",
               device="cuda") -> SCCResult:
    """Reference entry SCCSolver(m, nnz, in/out CSR, scc_root)
    (src/scc/scc.h:29)."""
    dev = resolve_device(device)
    if variant not in VARIANTS:
        raise ValueError(f"unknown SCC variant {variant!r} "
                         f"({', '.join(VARIANTS)})")
    m = g.m
    if max_rounds is None:
        max_rounds = m + 2
    src, dst = (t.long() for t in views.coo(g, dev))
    vid = torch.arange(m, dtype=torch.int32, device=dev)
    root = torch.full((m,), -1, dtype=torch.int32, device=dev)
    active = torch.ones(m, dtype=torch.bool, device=dev)
    region = torch.zeros(m, dtype=torch.int32, device=dev)
    jump_steps = max(1, int(np.ceil(np.log2(max(m, 2)))) + 1)
    it = 0
    while it < max_rounds and bool(active.any()):
        root, active = _trim(m, src, dst, vid, root, active)
        if variant == "color":
            ea = active[src] & active[dst]
            color = torch.where(active, vid, -1)
            changed = bool(active.any())
            while changed:
                x = torch.where(ea, color[src], -1)
                pushed = _scatter(m, dst, x, 0, "amax")
                new = torch.where(active, torch.maximum(color, pushed),
                                  color)
                changed = bool((new != color).any())
                color = new
            pivots = active & (color == vid)
            # backward closure from the pivots, within equal colour
            ea_c = ea & (color[src] == color[dst])
            in_scc = active & _reach(m, pivots, ea_c, dst, src)
            root = torch.where(in_scc, color, root)
        else:
            ea = active[src] & active[dst] & (region[src] == region[dst])
            comp = vid
            changed = bool(active.any())
            while changed:
                low_d = _scatter(m, dst, torch.where(ea, comp[src], m), m,
                                 "amin")
                low_s = _scatter(m, src, torch.where(ea, comp[dst], m), m,
                                 "amin")
                new = torch.minimum(comp, torch.minimum(low_d, low_s))
                for _ in range(jump_steps):
                    new = new[new.long()]
                changed = bool((new != comp).any())
                comp = new
            # one pivot a component: its largest active vertex
            piv_of_comp = _scatter(m, torch.where(active, comp, m - 1).long(),
                                   torch.where(active, vid, -1), -1, "amax")
            pivot_id = piv_of_comp[comp.long()]
            pivots = active & (vid == pivot_id)
            fwd = _reach(m, pivots, ea, src, dst)
            bwd = _reach(m, pivots, ea, dst, src)
            in_scc = active & fwd & bwd
            root = torch.where(in_scc, pivot_id, root)
            # region tags refine the next round's partition: 0 forward
            # only, 1 backward only, 2 neither, offset by component
            region = torch.where(fwd & ~bwd, comp * 3,
                                 torch.where(bwd & ~fwd, comp * 3 + 1,
                                             comp * 3 + 2))
        active = active & ~in_scc
        it += 1
    return SCCResult(root, it)
