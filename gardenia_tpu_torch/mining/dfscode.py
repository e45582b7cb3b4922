"""gSpan-style DFS-code canonical forms for small labelled patterns; the
port's copy of gardenia_tpu/mining/dfscode.py (pure Python, held equal to
it by tests/test_torch_fsm.py).

Counterpart of reference include/dfscode/dfs_code.hpp and the
quick-pattern -> canonical-pattern aggregation of
include/mining/edge_miner.h:124-196 (which uses bliss).  Patterns here
are tiny (<= k edges, k ~ 2-6), so the minimum DFS code is computed by
exhaustive enumeration of connected edge orderings and memoized; the
bliss machinery is unnecessary at this scale.

A pattern is (num_vertices, edges, vlabels) with vertices 0..nv-1 and
undirected edges as (i, j) pairs.  Its DFS code for a given discovery
order is the tuple of (a, b, la, lb) rows — endpoint discovery indices
and labels — listed in the order edges are added; the canonical form is
the lexicographic minimum over all connected edge orderings (a superset
of gSpan's rightmost-path-valid orderings, hence an equally valid
isomorphism invariant).  `canonical` also returns the permutation
sending pattern positions to canonical positions, used to store
embeddings in canonical vertex order.
"""

from __future__ import annotations

from functools import lru_cache
from itertools import permutations
from typing import Dict, List, Tuple

Edge = Tuple[int, int]
Pattern = Tuple[int, Tuple[Edge, ...], Tuple[int, ...]]  # (nv, edges, labels)


def make_pattern(nv: int, edges, vlabels) -> Pattern:
    es = tuple(sorted((min(i, j), max(i, j)) for i, j in edges))
    return (int(nv), es, tuple(int(x) for x in vlabels))


@lru_cache(maxsize=None)
def canonical(pattern: Pattern) -> Tuple[tuple, Tuple[int, ...]]:
    """(canonical code, perm) with perm[p] = canonical position of
    pattern vertex p.  Equal codes <=> isomorphic patterns."""
    nv, edges, labels = pattern
    if not edges:
        # isolated-vertex patterns don't occur in edge mining; order by
        # label for completeness
        order = sorted(range(nv), key=lambda v: labels[v])
        perm = [0] * nv
        for pos, v in enumerate(order):
            perm[v] = pos
        return (("v",) + tuple(sorted(labels)), tuple(perm))

    adj: List[List[int]] = [[] for _ in range(nv)]
    for i, j in edges:
        adj[i].append(j)
        adj[j].append(i)

    best_code: list = []
    best_disc: list = []

    def grow(code, used_edges, disc, disc_of):
        nonlocal best_code, best_disc
        if best_code and code > best_code[:len(code)]:
            return                                   # prune: can't win
        if len(used_edges) == len(edges):
            if not best_code or code < best_code:
                best_code = list(code)
                best_disc = list(disc)
            return
        # candidate next edges: incident to a discovered vertex
        for i, j in edges:
            if (i, j) in used_edges:
                continue
            for a, b in ((i, j), (j, i)):
                if a in disc_of:
                    row = (disc_of[a],
                           disc_of.get(b, len(disc)),
                           labels[a], labels[b])
                    new_disc = disc
                    new_disc_of = disc_of
                    if b not in disc_of:
                        new_disc = disc + [b]
                        new_disc_of = dict(disc_of)
                        new_disc_of[b] = len(disc)
                    grow(code + [row], used_edges | {(i, j)},
                         new_disc, new_disc_of)

    for v in range(nv):
        grow([], frozenset(), [v], {v: 0})

    perm = [0] * nv
    for pos, v in enumerate(best_disc):
        perm[v] = pos
    return (tuple(best_code), tuple(perm))


@lru_cache(maxsize=None)
def automorphisms(pattern: Pattern) -> Tuple[Tuple[int, ...], ...]:
    """All label- and edge-preserving permutations of the pattern
    (brute force; patterns are tiny).  Used to close MNI domains under
    vertex-position equivalence, exactly as the reference unions
    equivalent positions (edge_miner.h:175-193)."""
    nv, edges, labels = pattern
    eset = set(edges)
    autos = []
    for p in permutations(range(nv)):
        if any(labels[p[v]] != labels[v] for v in range(nv)):
            continue
        if all((min(p[i], p[j]), max(p[i], p[j])) in eset
               for i, j in edges):
            autos.append(tuple(p))
    return tuple(autos)


def apply_perm(pattern: Pattern, perm) -> Pattern:
    """Relabel pattern vertices: new id of v = perm[v]."""
    nv, edges, labels = pattern
    new_labels = [0] * nv
    for v in range(nv):
        new_labels[perm[v]] = labels[v]
    new_edges = tuple((min(perm[i], perm[j]), max(perm[i], perm[j]))
                      for i, j in edges)
    return make_pattern(nv, new_edges, new_labels)


def extensions(pattern: Pattern) -> List[Tuple[str, int, int]]:
    """Structural one-edge extensions of a pattern:
    ('fwd', anchor_pos, -1): add new vertex nv adjacent to the anchor
    (its label is discovered from the data);
    ('back', i, j): add the missing edge (i, j).
    Exhaustive (all positions) — completeness over gSpan's rightmost
    -path minimality; canonical-form dedup collapses the redundancy."""
    nv, edges, _ = pattern
    eset = set(edges)
    out: List[Tuple[str, int, int]] = []
    for i in range(nv):
        out.append(("fwd", i, -1))
    for i in range(nv):
        for j in range(i + 1, nv):
            if (i, j) not in eset:
                out.append(("back", i, j))
    return out
