"""General frequent-subgraph mining engine — gSpan-style pattern growth
with DFS-code canonical aggregation and MNI domain support; torch
counterpart of gardenia_tpu/mining/gspan.py.

Reference: mining/fsm2/miner.h + include/mining/edge_miner.h (Pangolin
edge miner: BFS embedding expansion -> quick-pattern aggregation ->
canonical aggregation with vertex-position equivalences -> domain
support filter, repeated up to k edges).  Canonical forms are minimum
DFS codes (mining/dfscode.py, exhaustive — patterns are tiny) in place of
the reference's bliss; embeddings live in dense (n_positions, N) int32
arrays in canonical vertex order.

Support convention (= the reference's, edge_miner.h:175-193): MNI with
vertex-position equivalence — domain of canonical position p is the set
of graph vertices reachable at ANY position in p's automorphism orbit,
support = min over positions.  This equals the standard "minimum image"
support over all subgraph isomorphisms.

Every connected edge-subgraph occurrence is generated at least once
(extensions are exhaustive over positions); duplicates are collapsed by
canonical reordering + column dedup, and automorphism closure supplies
the remaining isomorphism images.

On the device: a pattern's embeddings are uploaded once, and each
forward extension (every (embedding, neighbour of the anchor position)
wedge whose neighbour is none of the embedding's vertices) runs through
the pattern engine's count / nonzero / fill passes
(pattern.wedge_survivors), each back-edge extension through kcl._member.
Level 1, the column dedup (np.unique(axis=1)), the canonical forms and
the MNI supports stay on the host, as in the reference.  The JAX
package's pow2 padding of N and of the chunk (one jit compile a size
class) does not come across.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gardenia_tpu_torch import resolve_device
from gardenia_tpu_torch.core import build, views
from gardenia_tpu_torch.mining.dfscode import (Pattern, apply_perm,
                                               automorphisms, canonical,
                                               extensions, make_pattern)
from gardenia_tpu_torch.mining.kcl import (EMB_WEDGE_LIMIT, _member,
                                           search_rounds, wedge_slices)
from gardenia_tpu_torch.mining.labels import default_labels
from gardenia_tpu_torch.mining.pattern import CHUNK, wedge_survivors

# safety valve: total embedding columns held per level
MAX_EMBEDDINGS = 50_000_000


def _reorder(rows: np.ndarray, perm) -> np.ndarray:
    """rows (n, N) in pattern-position order -> canonical order
    (perm[p] = canonical position of pattern position p)."""
    out = np.empty_like(rows)
    for p in range(rows.shape[0]):
        out[perm[p]] = rows[p]
    return out


def mni_support(pattern: Pattern, M: np.ndarray) -> int:
    """Minimum-image support of embeddings M (nv, N) in canonical
    position order, closed under the pattern's automorphisms."""
    if M.size == 0:
        return 0
    nv = pattern[0]
    autos = automorphisms(pattern)
    # orbit of each position under Aut
    best = None
    seen_orbits = set()
    for p in range(nv):
        orbit = frozenset(sigma[p] for sigma in autos)
        if orbit in seen_orbits:
            continue
        seen_orbits.add(orbit)
        dom = len(np.unique(M[sorted(orbit)]))
        best = dom if best is None else min(best, dom)
    return int(best)


def fsm_gspan(g, k: int, minsup: int,
              labels: Optional[np.ndarray] = None, *,
              chunk: int = CHUNK, device="cuda") -> int:
    """Count frequent connected edge-patterns with 1..k edges
    (cumulative over levels, matching the prior FSM convention)."""
    m = g.m
    if k < 1 or m == 0 or g.nnz == 0:
        return 0
    labels = default_labels(g, labels)

    dev = resolve_device(device)
    rowptr, colidx = views.csr(g, dev)
    nnz = g.nnz
    deg = rowptr[1:] - rowptr[:-1]
    rounds = search_rounds(g.max_degree)

    # ---- level 1: single edges -------------------------------------------
    src, dst = build.csr_to_coo(g.rowptr, g.colidx)
    once = src < dst
    u, v = src[once].astype(np.int64), dst[once].astype(np.int64)
    lu, lv = labels[u], labels[v]

    groups: Dict[tuple, Tuple[Pattern, np.ndarray]] = {}
    pair_keys = np.minimum(lu, lv) * (labels.max() + 1) + \
        np.maximum(lu, lv)
    for keyval in np.unique(pair_keys):
        sel = pair_keys == keyval
        us, vs, lus, lvs = u[sel], v[sel], lu[sel], lv[sel]
        # orient position 0 to the smaller label
        swap = lus > lvs
        a = np.where(swap, vs, us)
        b = np.where(swap, us, vs)
        la = int(labels[a[0]])
        lb = int(labels[b[0]])
        pat = make_pattern(2, ((0, 1),), (la, lb))
        ckey, perm = canonical(pat)
        M = _reorder(np.stack([a, b]).astype(np.int32), perm)
        groups[ckey] = (apply_perm(pat, perm), M)

    total = 0
    frequent: Dict[tuple, Tuple[Pattern, np.ndarray]] = {}
    for ckey, (pat, M) in groups.items():
        if mni_support(pat, M) >= minsup:
            frequent[ckey] = (pat, M)
    total += len(frequent)
    if k == 1:
        return total

    # ---- levels 2..k: pattern growth -------------------------------------
    for _level in range(2, k + 1):
        raw: Dict[tuple, List[np.ndarray]] = defaultdict(list)
        child_pat: Dict[tuple, Pattern] = {}
        for ckey, (pat, M) in frequent.items():
            nv = pat[0]
            M_d = torch.from_numpy(np.ascontiguousarray(M)).to(dev)
            for kind, i, j in extensions(pat):
                if kind == "back":
                    # closing edge (i, j): keep embeddings where
                    # v_j in N(v_i)
                    hit = _member(rowptr, colidx, nnz, M_d[j], M_d[i],
                                  rounds).cpu().numpy()
                    if not hit.any():
                        continue
                    child = make_pattern(
                        nv, pat[1] + ((i, j),), pat[2])
                    ck, perm = canonical(child)
                    child_pat.setdefault(ck, apply_perm(child, perm))
                    raw[ck].append(_reorder(M[:, hit], perm))
                    continue
                # forward extension from anchor position i: x, a
                # neighbour of v_i that is none of the embedding's vertices
                wpe = deg[M_d[i].long()]
                outs_m: List[np.ndarray] = []
                outs_x: List[np.ndarray] = []
                for lo, hi in wedge_slices(wpe.cpu().numpy(),
                                           EMB_WEDGE_LIMIT):
                    sub = M_d[:, lo:hi]

                    def fresh(e, x, sub=sub):
                        ok = torch.ones(x.shape, dtype=torch.bool,
                                        device=dev)
                        for t in range(nv):
                            ok &= x != sub[t, e]
                        return ok
                    e, x = wedge_survivors(rowptr, colidx, sub[i],
                                           wpe[lo:hi], fresh, chunk)
                    if e.numel():
                        outs_m.append(sub[:, e].cpu().numpy())
                        outs_x.append(x.cpu().numpy())
                if not outs_m:
                    continue
                Mext = np.concatenate(outs_m, axis=1)
                X = np.concatenate(outs_x)
                lx = labels[X]
                for lab in np.unique(lx):
                    sel = lx == lab
                    child = make_pattern(
                        nv + 1, pat[1] + ((i, nv),),
                        pat[2] + (int(lab),))
                    ck, perm = canonical(child)
                    child_pat.setdefault(ck, apply_perm(child, perm))
                    arr = np.concatenate(
                        [Mext[:, sel], X[sel][None, :]], axis=0)
                    raw[ck].append(_reorder(arr, perm))

        frequent = {}
        n_cols = sum(sum(a.shape[1] for a in lst)
                     for lst in raw.values())
        if n_cols > MAX_EMBEDDINGS:
            raise MemoryError(
                f"FSM level {_level} embedding frontier has {n_cols:.2e}"
                " columns; reduce k or raise minsup")
        for ck, arrs in raw.items():
            M = np.unique(np.concatenate(arrs, axis=1), axis=1)
            pat = child_pat[ck]
            if mni_support(pat, M) >= minsup:
                frequent[ck] = (pat, M)
        total += len(frequent)
        if not frequent:
            break
    return total



# ---- independent brute-force oracle ---------------------------------------

def fsm_bruteforce(g, k: int, minsup: int,
                   labels: Optional[np.ndarray] = None) -> int:
    """Enumerate every connected edge-subgraph with <= k edges by
    recursive edge addition (host, exact); aggregate true MNI domains
    per canonical pattern.  Independent of the device engine except for
    the canonical-form key."""
    m = g.m
    if k < 1 or m == 0 or g.nnz == 0:
        return 0
    labels = default_labels(g, labels)
    rp, ci = g.rowptr, g.colidx
    edges = sorted({(min(int(a), int(b)), max(int(a), int(b)))
                    for a in range(m)
                    for b in ci[rp[a]:rp[a + 1]].tolist() if a != b})
    incident: Dict[int, List[int]] = defaultdict(list)
    for idx, (a, b) in enumerate(edges):
        incident[a].append(idx)
        incident[b].append(idx)

    subsets_by_size: List[set] = [set() for _ in range(k + 1)]

    def expand(eset: frozenset, verts: frozenset):
        size = len(eset)
        if eset in subsets_by_size[size]:
            return
        subsets_by_size[size].add(eset)
        if size == k:
            return
        cand = set()
        for vtx in verts:
            cand.update(incident[vtx])
        for idx in cand:
            if idx not in eset:
                a, b = edges[idx]
                expand(eset | {idx}, verts | {a, b})

    for idx, (a, b) in enumerate(edges):
        expand(frozenset([idx]), frozenset([a, b]))

    total = 0
    for size in range(1, k + 1):
        doms: Dict[tuple, List[set]] = {}
        pats: Dict[tuple, Pattern] = {}
        for eset in subsets_by_size[size]:
            es = [edges[i] for i in eset]
            verts = sorted({x for e in es for x in e})
            pos = {vtx: p for p, vtx in enumerate(verts)}
            pat = make_pattern(len(verts),
                               [(pos[a], pos[b]) for a, b in es],
                               [labels[vtx] for vtx in verts])
            ck, perm = canonical(pat)
            cpat = apply_perm(pat, perm)
            pats.setdefault(ck, cpat)
            d = doms.setdefault(ck, [set() for _ in range(len(verts))])
            # all isomorphism images = automorphism closure of one
            base = [0] * len(verts)
            for vtx in verts:
                base[perm[pos[vtx]]] = vtx
            for sigma in automorphisms(cpat):
                for p in range(len(verts)):
                    d[p].add(base[sigma[p]])
        total += sum(1 for ck, d in doms.items()
                     if min(len(s) for s in d) >= minsup)
    return total
