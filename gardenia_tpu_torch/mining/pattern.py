"""Generic vertex-induced pattern enumeration by level expansion; torch
counterpart of gardenia_tpu/mining/pattern.py.

The replacement for the reference's AutoMine-generated nested loops
(mining/sgl/{diamond,rectangle,pentagon,house}.h, mining/kcl_dfs/
automine_omp.h): a pattern is a declarative spec — per level, the anchor
whose neighbourhood supplies candidates, required adjacencies, required
non-adjacencies (induced matching) and id-order symmetry-breaking
constraints — and one engine expands embeddings level by level on the
device: each (embedding, slot of its anchor's CSR row) wedge yields a
candidate, each constraint is a vectorised test (adjacency by
kcl._member's binary search), the survivors are compacted.  Embeddings
live in (level, N) int32 tensors; the wedge space is cut into slices of
at most EMB_WEDGE_LIMIT wedges (the memory budget of one slice), each
taken `chunk` wedges a step by a count pass into one bool a wedge, one
nonzero and a fill pass (`wedge_survivors`), so the host reads once a
slice.  The last level only counts.  Indices are int64: the JAX
package's int32 guards and row-select gathers do not come across.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import views
from gardenia_tpu_torch.mining.kcl import (EMB_WEDGE_LIMIT, _member,
                                           search_rounds, wedge_slices)

# wedges a step; the result does not depend on it
CHUNK = 1 << 23


@dataclass(frozen=True)
class Level:
    """Constraints for vertex v_i (i = position, >= 1)."""
    anchor: int                       # candidates come from N(v_anchor)
    adj: Tuple[int, ...] = ()         # must be adjacent to these members
    nonadj: Tuple[int, ...] = ()      # must NOT be adjacent (induced)
    gt: Tuple[int, ...] = ()          # candidate id > member id
    lt: Tuple[int, ...] = ()          # candidate id < member id
    ne: Tuple[int, ...] = ()          # candidate id != member id


@dataclass(frozen=True)
class PatternSpec:
    name: str
    levels: Tuple[Level, ...]         # levels[0] describes v_1


def _wedges(rowptr, colidx, anchors, wpe, cum, j):
    """(e, x) of wedge slots j: embedding e and x, the slot's neighbour of
    anchors[e]."""
    e = torch.searchsorted(cum, j, right=True)
    return e, colidx[rowptr[anchors[e].long()] + j - (cum[e] - wpe[e])]


def _steps(cum: torch.Tensor, chunk: int):
    """The wedge slots of `cum`'s space, `chunk` a step (int64)."""
    total = int(cum[-1]) if cum.numel() else 0
    for s in range(0, total, chunk):
        yield torch.arange(s, min(total, s + chunk), dtype=torch.int64,
                           device=cum.device)


def wedge_survivors(rowptr: torch.Tensor, colidx: torch.Tensor,
                    anchors: torch.Tensor, wpe: torch.Tensor,
                    test: Callable, chunk: int = CHUNK):
    """(e int64, x): the wedges (embedding e, x = a neighbour of
    anchors[e]) for which test(e, x) holds, in wedge order.  wpe[e] =
    deg(anchors[e]) (int64); a count pass over `chunk` wedges a step into
    one bool a wedge, one nonzero, then a fill pass."""
    cum = torch.cumsum(wpe, 0)
    ok = torch.cat([test(*_wedges(rowptr, colidx, anchors, wpe, cum, j))
                    for j in _steps(cum, chunk)]
                   or [torch.zeros(0, dtype=torch.bool, device=cum.device)])
    keep = torch.nonzero(ok).flatten()
    del ok
    parts = [_wedges(rowptr, colidx, anchors, wpe, cum, keep[s:s + chunk])
             for s in range(0, max(keep.numel(), 1), chunk)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def wedge_count(rowptr: torch.Tensor, colidx: torch.Tensor,
                anchors: torch.Tensor, wpe: torch.Tensor, test: Callable,
                chunk: int = CHUNK) -> torch.Tensor:
    """int64 scalar tensor: the number of wedges (as `wedge_survivors`)
    for which test(e, x) holds, summed on the device."""
    cum = torch.cumsum(wpe, 0)
    count = torch.zeros((), dtype=torch.int64, device=cum.device)
    for j in _steps(cum, chunk):
        count += test(*_wedges(rowptr, colidx, anchors, wpe, cum, j)).sum()
    return count


def count_pattern(g, spec: PatternSpec, *, chunk: int = CHUNK,
                  device="cuda") -> int:
    """Count embeddings of `spec` in the symmetric graph g."""
    m, nnz = g.m, g.nnz
    if nnz == 0:
        return 0
    dev = resolve_device(device)
    rowptr, colidx = views.csr(g, dev)
    deg = rowptr[1:] - rowptr[:-1]
    rounds = search_rounds(g.max_degree)

    def constraints(level: Level, members: torch.Tensor):
        def test(e, x):
            ok = torch.ones(x.shape, dtype=torch.bool, device=dev)
            for i in range(members.shape[0]):
                vi = members[i, e]
                if i in level.ne or i in level.adj or i in level.nonadj:
                    ok &= x != vi
                if i in level.gt:
                    ok &= x > vi
                if i in level.lt:
                    ok &= x < vi
            for i in level.adj:
                if i != level.anchor:
                    ok &= _member(rowptr, colidx, nnz, x, members[i, e],
                                  rounds)
            for i in level.nonadj:
                ok &= ~_member(rowptr, colidx, nnz, x, members[i, e],
                               rounds)
            return ok
        return test

    members = torch.arange(m, dtype=torch.int32, device=dev)[None, :]
    total_count = torch.zeros((), dtype=torch.int64, device=dev)
    n_levels = len(spec.levels)
    for li, level in enumerate(spec.levels):
        count_only = li == n_levels - 1
        wpe_all = deg[members[level.anchor].long()]
        wpe_h = wpe_all.cpu().numpy()
        if int(wpe_h.sum()) == 0:
            return int(total_count)
        outs = []
        for lo, hi in wedge_slices(wpe_h, EMB_WEDGE_LIMIT):
            sub = members[:, lo:hi]
            args = (rowptr, colidx, sub[level.anchor], wpe_all[lo:hi],
                    constraints(level, sub), chunk)
            if count_only:
                total_count += wedge_count(*args)
                continue
            e, x = wedge_survivors(*args)
            if e.numel():
                outs.append(torch.cat([sub[:, e], x[None, :]]))
        if not count_only:
            if not outs:
                return 0
            members = torch.cat(outs, dim=1)
    return int(total_count)


# --- pattern library (mining/sgl/pattern.h:5-18) ---------------------------
# Induced matching with symmetry breaking; each pattern's automorphism
# group is quotiented by id-order constraints so every embedding is
# counted exactly once (verified against brute force in tests).

# diamond: chord (v0,v1), opposite vertices v2,v3 mutually non-adjacent
DIAMOND = PatternSpec("diamond", (
    Level(anchor=0, adj=(0,), lt=(0,)),                  # v1 < v0, chord
    Level(anchor=0, adj=(0, 1)),                         # v2 ~ both
    Level(anchor=0, adj=(0, 1), nonadj=(2,), lt=(2,)),   # v3 < v2
))

# rectangle (induced 4-cycle): v0-v1-v2-v3, diagonals absent;
# canonical: v0 = min, v1 < v3
RECTANGLE = PatternSpec("rectangle", (
    Level(anchor=0, adj=(0,), gt=(0,)),                   # v1 > v0
    Level(anchor=1, adj=(1,), nonadj=(0,), gt=(0,)),      # v2 ~ v1, !~v0
    Level(anchor=2, adj=(2, 0), nonadj=(1,), gt=(0, 1)),  # v3 closes, v3 > v1
))

# pentagon (induced 5-cycle): canonical v0 = min, v1 < v4
PENTAGON = PatternSpec("pentagon", (
    Level(anchor=0, adj=(0,), gt=(0,)),                       # v1
    Level(anchor=1, adj=(1,), nonadj=(0,), gt=(0,)),          # v2
    Level(anchor=2, adj=(2,), nonadj=(0, 1), gt=(0,)),        # v3
    Level(anchor=3, adj=(3, 0), nonadj=(1, 2), gt=(0, 1)),    # v4 > v1
))

# house: square v0-v1-v2-v3 + roof v4 ~ {v0, v1}; induced non-edges
# {02, 13, 24, 34}; mirror symmetry broken by v0 < v1
HOUSE = PatternSpec("house", (
    Level(anchor=0, adj=(0,), gt=(0,)),                       # v1 > v0
    Level(anchor=1, adj=(1,), nonadj=(0,)),                   # v2 ~ v1
    Level(anchor=2, adj=(2, 0), nonadj=(1,)),                 # v3 square
    Level(anchor=0, adj=(0, 1), nonadj=(2, 3)),               # v4 roof
))

PATTERNS = {p.name: p for p in (DIAMOND, RECTANGLE, PENTAGON, HOUSE)}
