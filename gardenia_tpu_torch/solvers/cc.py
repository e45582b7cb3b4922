"""CC — connected components (Shiloach-Vishkin / Afforest); torch
counterpart of gardenia_tpu/solvers/cc.py (reference
src/cc/{cc.h,omp_afforest.cc,base.cu}).  Labels are representative vertex
ids; the verifier only requires label consistency (same component <=>
same label, src/cc/verifier.cc:35-60).

The JAX solvers fuse their round loop in one lax.while_loop with a
lax.switch over round kinds; here the loop runs on the host and reads
back once per round (cc_sv: the next round's `scout` and whether any
label changed; cc_afforest: whether any label changed), plus one `.any()`
per pointer-jumping level (ops/pointer_jump.py).  JAX's `.at[i].min(v,
mode="drop")` drops out-of-range indices; those scatters go through
`Semiring.scatter_into`, which does the same on the card.

cc_sv layouts for the dense round's label sweep:
  'hybrid' — the degree-relabelled hybrid layout (ops/bsr.py): dense
             panels through kernel K2 (ops/minselect.py), the remainder
             through the ELL min-select.  Labels live in relabelled ids
             until the end.
  'ell'    — ELL slabs over the original ids.
  'auto'   — hybrid (the reference's production layout, cc.py:64-73).
The layout's matrices are built and uploaded at the first dense round, not
at the first solve: no R-MAT solve takes a dense round, and building and
uploading the hybrid layout's 4 GB of panels at R-MAT-20 took 15 of the
first solve's 31 seconds (the relabelling is the rest).  What the 'hybrid'
layout always gives is the degree-relabelled id space, in which an
R-MAT-20 solve takes one round where the original ids ('ell') take two
(the card's times are in PERF.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import types as T
from gardenia_tpu_torch.core import views
from gardenia_tpu_torch.ops import bsr
from gardenia_tpu_torch.ops.frontier import (compact_mask,
                                             expand_frontier_edges,
                                             frontier_degree_sum)
from gardenia_tpu_torch.ops.pointer_jump import pointer_jump
from gardenia_tpu_torch.ops.semiring import I32_MIN_SELECT2
from gardenia_tpu_torch.ops.spmv import spmv_ell

SENT = int(np.iinfo(np.int32).max)
SAMPLE = 1024          # vertices sampled for the frequent component


@dataclasses.dataclass
class CCResult:
    comp: torch.Tensor     # i32[m] representative labels, original ids
    iterations: int


def _smin(y: torch.Tensor, idx: torch.Tensor,
          vals: torch.Tensor) -> torch.Tensor:
    """y.at[idx].min(vals, mode="drop") — a new tensor."""
    return I32_MIN_SELECT2.scatter_into(y, idx, vals)


def _sample_idx(m: int, device) -> torch.Tensor:
    """The fixed 1024-vertex sample of the frequent-component search
    (cc.py:162-165, 322-324)."""
    return torch.from_numpy(
        np.random.default_rng(0).integers(0, m, SAMPLE, dtype=np.int64)
    ).to(device)


def _frequent_label(comp: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
    """The most frequent label in the sample (ties: the smallest label,
    as jnp.argmax picks the first maximum)."""
    counts = torch.zeros_like(comp)
    counts.index_add_(0, comp[sample].long(), torch.ones_like(sample,
                                                              dtype=comp.dtype))
    return torch.argmax(counts).to(torch.int32)


@dataclasses.dataclass
class _SVContext:
    """Device buffers and host constants of cc_sv on one graph."""
    layout: str
    # hybrid or ELL matrices, one per direction: None until the first
    # dense round asks for them (build_mats)
    mats: Optional[list]
    build_mats: Callable[[], list]
    dirs: List[Tuple[torch.Tensor, torch.Tensor]]   # CSR per direction
    deg_all: torch.Tensor           # i32[m] degree summed over dirs
    parts01: Optional[Tuple[torch.Tensor, torch.Tensor]]
    new_of_old: Optional[torch.Tensor]
    old_of_new: Optional[torch.Tensor]
    sample: torch.Tensor
    tiers: List[int]
    nnz: int


def _sv_context(g, layout: str, dev) -> _SVContext:
    if layout == "hybrid":
        gsrc, new_of_old, old_of_new = views.relabel_maps(g, dev)
        view = views.hybrid
    else:
        gsrc, new_of_old, old_of_new = g, None, None
        view = views.ell

    def build_mats():
        mats = [view(gsrc, dev)]
        if not g.symmetric:
            mats.append(view(gsrc, dev, reverse=True))
        return mats
    m, nnz = g.m, gsrc.nnz
    dirs = [views.csr(gsrc, dev)]
    deg_all = views.degrees(gsrc, dev)
    if not gsrc.symmetric:
        dirs.append(views.csr(gsrc, dev, reverse=True))
        deg_all = deg_all + views.degrees(gsrc, dev, reverse=True)
    # sparse-round capacities (cc.py:144-150): top tier clamped at 512K
    cap_base = min(T.next_pow2(max(len(dirs) * nnz // 8, 1024)), 1 << 19)
    tiers = []
    for shift in (8, 4, 0):
        ce = max(2048, cap_base >> shift)
        if ce not in tiers:
            tiers.append(ce)
    # host-precomputed r-th-neighbour partners of the two sampling
    # pre-rounds (cc.py:174-187)
    parts01 = None
    if nnz:
        rp = np.asarray(gsrc.rowptr, np.int64)
        ci = np.asarray(gsrc.colidx, np.int64)
        deg = np.diff(rp)
        vid = np.arange(m, dtype=np.int64)
        parts01 = tuple(
            torch.from_numpy(np.where(deg > r, ci[np.minimum(rp[:m] + r,
                                                             nnz - 1)],
                                      vid).astype(np.int32)).to(dev)
            for r in range(2))
    return _SVContext(layout, None, build_mats, dirs, deg_all, parts01,
                      new_of_old, old_of_new, _sample_idx(m, dev), tiers, nnz)


def _sweep(ctx: _SVContext, comp: torch.Tensor, m: int) -> torch.Tensor:
    """Each vertex's minimum neighbour label (SENT without neighbours),
    over every direction."""
    if ctx.mats is None:
        ctx.mats = ctx.build_mats()
    nbr = None
    for mat in ctx.mats:
        if ctx.layout == "hybrid":
            y = bsr.spmv_hybrid_min_select(mat, comp, num_rows=m,
                                           sentinel=SENT)
        else:
            y = spmv_ell(mat, comp, semiring=I32_MIN_SELECT2, num_rows=m)
        nbr = y if nbr is None else torch.minimum(nbr, y)
    return nbr


def _sparse_round(ctx: _SVContext, comp: torch.Tensor, live: torch.Tensor,
                  ce: int) -> torch.Tensor:
    """Two-sided relaxation of the live vertices' edges, both directions
    (cc.py:209-234), at edge capacity ce."""
    m = comp.shape[0]
    ids = compact_mask(live & (ctx.deg_all > 0),
                       min(T.next_pow2(max(m, 2)), ce), m)
    new = comp
    for rp, ci in ctx.dirs:
        src, dst, valid, _ = expand_frontier_edges(rp, ci, ids, ce)
        # invalid slots may carry the pad id m: read any label, drop the
        # write below
        lbl_s = comp[torch.clamp(src, max=m - 1)]
        lbl_d = comp[dst]
        new = _smin(new, torch.where(valid, dst, m), lbl_s)
        new = _smin(new, torch.where(valid, src, m), lbl_d)
    hooked = _smin(comp, comp, new)
    return torch.minimum(hooked, new)


def _dense_round(ctx: _SVContext, comp: torch.Tensor) -> torch.Tensor:
    """One min-select sweep over all edges, then each vertex's root and
    its new label's root hooked down (cc.py:236-247)."""
    m = comp.shape[0]
    nbr = _sweep(ctx, comp, m)
    new = torch.minimum(comp, nbr)
    hooked = _smin(comp, comp, new)
    hooked = _smin(hooked, torch.clamp(nbr, max=m - 1),
                   torch.where(nbr < m, new, m))
    return torch.minimum(hooked, comp)


def _round_stats(ctx: _SVContext, comp: torch.Tensor):
    """(live mask, scout): vertices off the sampled frequent label, and
    the edges they own."""
    live = comp != _frequent_label(comp, ctx.sample)
    return live, frontier_degree_sum(live, ctx.deg_all)


def cc_sv(g, *, layout: str = "auto", device="cuda") -> CCResult:
    """Gather-only Shiloach-Vishkin with the reference's round structure
    (cc.py:57-301): two Afforest-style sampling pre-rounds, then rounds
    that each pick, from `scout` (the edges owned by vertices off the
    sampled frequent label), a sparse round at one of the edge-capacity
    tiers or a dense round (a min-select sweep over every edge), followed
    by full pointer jumping; until no label changes."""
    if layout == "auto":
        layout = "hybrid"
    if layout not in ("hybrid", "ell"):
        raise ValueError(f"unknown CC layout {layout!r}")
    dev = resolve_device(device)
    m = g.m
    ctx = g._dev(views._key("cc_sv", dev, layout),
                 lambda: _sv_context(g, layout, dev))
    comp = torch.arange(m, dtype=torch.int32, device=dev)
    if ctx.nnz:
        p0, p1 = ctx.parts01
        # round 0 on identity labels: the partner's label is the partner
        comp = pointer_jump(torch.minimum(_smin(comp, p0, comp), p0))
        # round 1: two-sided root hook on live labels
        ld = comp[p1]
        comp = pointer_jump(_smin(_smin(comp, ld, comp), comp, ld))
    live, scout = _round_stats(ctx, comp)
    scout = int(scout)
    it = 0
    while True:
        idx = sum(int(scout > ce) for ce in ctx.tiers)
        if idx < len(ctx.tiers):
            comp2 = _sparse_round(ctx, comp, live, ctx.tiers[idx])
        else:
            comp2 = _dense_round(ctx, comp)
        comp2 = pointer_jump(comp2)
        it += 1
        live, scout_t = _round_stats(ctx, comp2)
        # the round's one read: whether it changed a label, and the next
        # round's scout
        changed, scout = torch.stack(
            [(comp2 != comp).any().long(), scout_t.long()]).tolist()
        comp = comp2
        if not changed:
            break
    if ctx.new_of_old is not None:
        # back to original ids: positions via new_of_old, label values
        # via old_of_new
        comp = ctx.old_of_new[comp[ctx.new_of_old]].to(torch.int32)
    return CCResult(comp, it)


def _hook_edges(comp: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor) -> torch.Tensor:
    """Two-sided union by min label (Link, omp_afforest.cc:12-25)."""
    ls, ld = comp[src], comp[dst]
    return _smin(_smin(comp, ld, ls), ls, ld)


def cc_afforest(g, neighbor_rounds: int = 2, *, device="cuda") -> CCResult:
    """Afforest (omp_afforest.cc:37-83, cc.py:304-352): `neighbor_rounds`
    sampling rounds hook only each vertex's r-th neighbour; the most
    frequent label of a 1024-vertex sample is found; then hooking rounds
    over all edges skip those inside that component."""
    dev = resolve_device(device)
    m = g.m
    rowptr, colidx = views.csr(g, dev)
    src, dst = views.coo(g, dev)
    nnz = colidx.shape[0]
    comp = torch.arange(m, dtype=torch.int32, device=dev)
    vid = comp.clone()
    for r in range(neighbor_rounds):
        start = rowptr[:-1] + r
        has = start < rowptr[1:]
        partner = (colidx[torch.clamp(start, max=nnz - 1)] if nnz
                   else vid)
        partner = torch.where(has, partner, vid)
        comp = pointer_jump(_hook_edges(comp, vid, partner))
    biggest = _frequent_label(comp, _sample_idx(m, dev))
    it = 0
    while True:
        ls, ld = comp[src], comp[dst]
        # skip edges fully inside the biggest component
        keep = (ls != biggest) | (ld != biggest)
        new = _smin(comp, torch.where(keep, ld, m), ls)
        new = pointer_jump(_smin(new, torch.where(keep, ls, m), ld))
        it += 1
        changed = bool((new != comp).any())
        comp = new
        if not changed:
            break
    return CCResult(comp, it + neighbor_rounds)


VARIANTS = {"sv": cc_sv, "afforest": cc_afforest}


def cc_solver(g, *, variant: str = "afforest", device="cuda") -> CCResult:
    """Reference entry CCSolver(g, comp) (src/cc/cc.h:30)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown CC variant {variant!r}")
    return VARIANTS[variant](g, device=device)
