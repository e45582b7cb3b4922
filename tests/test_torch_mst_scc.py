"""The port's Boruvka MST, FB-Trim SCC, threshold clustering and random
walks (gardenia_tpu_torch.solvers.{mst,scc,clustering,sampling}) against
the JAX solvers and the serial oracles on the same numpy-seeded graphs,
on the CPU.  MST: total weight exact (the port's is the f64 sum, which
the JAX solver rounds to f32), the same edge slots and canonical edge ids
chosen.  SCC: labels a bijection of the JAX solver's (here
equal) and of Tarjan's, `iterations` equal.  Clustering: labels equal.
Random walks have no JAX counterpart bit for bit (jax.random's stream):
they are held to the graph, to their seed and to a binomial bound."""

import numpy as np
import pytest
import torch

from tests.conftest import random_graph

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.core.graph import Graph, from_edges
from gardenia_tpu.core.io import EdgeListData
from gardenia_tpu.solvers.clustering import cluster_threshold as jcluster
from gardenia_tpu.solvers.mst import mst_solver as jmst
from gardenia_tpu.solvers.scc import scc_solver as jscc
from gardenia_tpu.verify import oracles

from gardenia_tpu_torch.bench import mst_graph
from gardenia_tpu_torch.cli import same_components
from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.solvers.clustering import cluster_threshold
from gardenia_tpu_torch.solvers.mst import mst_solver
from gardenia_tpu_torch.solvers.sampling import random_walks
from gardenia_tpu_torch.solvers.scc import scc_solver


# --- MST ---------------------------------------------------------------------

def _mst_graph(kind):
    if kind.startswith("random"):
        return random_graph(m=100, avg_deg=4, seed=int(kind[-1]),
                            weighted=True, symmetric=True)
    if kind == "forest":        # unweighted, several components
        return random_graph(m=90, avg_deg=2, seed=5, symmetric=True)
    if kind == "fractional":    # f32 weights truncated to int32 by both
        g = random_graph(m=120, avg_deg=5, seed=8, symmetric=True)
        src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
        lo, hi = np.minimum(src, g.colidx), np.maximum(src, g.colidx)
        w = ((lo * 31 + hi * 17) % 13) / 3.0 + 0.5
        return Graph(g.rowptr, g.colidx, w, num_cols=g.n, symmetric=True)
    g = generate_graph("rmat", scale=10, symmetrize=True)
    return Graph(*(a for a in (g.rowptr, g.colidx)),
                 mst_graph(from_csr_of(g)).weights, num_cols=g.n,
                 symmetric=True)


@pytest.mark.parametrize("kind", ["random0", "random3", "forest",
                                  "fractional", "rmat10_bench"])
def test_mst_matches_jax_and_oracle(kind):
    g = _mst_graph(kind)
    res = mst_solver(from_csr_of(g), device="cpu")
    want = jmst(g)
    # the port keeps the f64 sum that the JAX solver rounds to f32
    assert np.float32(res.total_weight) == np.float32(want.total_weight)
    chosen = res.edge_mask.numpy()
    np.testing.assert_array_equal(chosen, np.asarray(want.edge_mask))
    np.testing.assert_array_equal(res.comp.numpy(), np.asarray(want.comp))
    # the same canonical undirected edges, each once
    src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    key = np.minimum(src, g.colidx) * np.int64(g.m) + np.maximum(src,
                                                                 g.colidx)
    assert len(np.unique(key[chosen])) == \
        g.m - len(np.unique(oracles.cc_serial(g)))
    if kind != "fractional":    # Kruskal sums the untruncated weights
        assert res.total_weight == oracles.mst_total_weight(g)


# --- SCC ---------------------------------------------------------------------

def _chain_of_2cycles(n=60):
    src, dst = [], []
    for i in range(n):
        a, b = 2 * i, 2 * i + 1
        src += [a, b]
        dst += [b, a]
        if i < n - 1:
            src += [b]
            dst += [2 * i + 2]
    order = np.lexsort((dst, src))
    src, dst = np.asarray(src)[order], np.asarray(dst)[order]
    rp = np.zeros(2 * n + 1, np.int64)
    np.add.at(rp, src + 1, 1)
    return Graph(np.cumsum(rp), dst.astype(np.int32))


def _trim2_chain():
    src, dst = [], []
    for i in range(0, 20, 2):
        src += [i, i + 1]
        dst += [i + 1, i]
        if i + 2 < 20:
            src.append(i + 1)
            dst.append(i + 2)
    return from_edges(EdgeListData(20, 20, np.array(src, np.int32),
                                   np.array(dst, np.int32)))


def _nested_cycles():
    """Rings of 10 with chords inside each, each ring joined to the one
    below it (ring r + 1 -> ring r): every ring's colour is the top
    ring's largest id, so the colour variant peels one ring a round."""
    rng = np.random.default_rng(7)
    src, dst = [], []
    for r in range(12):
        base, k = r * 10, 10
        for i in range(k):
            src.append(base + i)
            dst.append(base + (i + 1) % k)
        src += list(base + rng.integers(0, k, 3))
        dst += list(base + rng.integers(0, k, 3))
        if r < 11:
            src.append(base + 13)
            dst.append(base + 3)
    return from_edges(EdgeListData(120, 120, np.array(src, np.int32),
                                   np.array(dst, np.int32)))


def _scc_graph(kind):
    if kind.startswith("random"):
        seed, deg = {"random0": (0, 2), "random1": (1, 3), "random4": (4, 1),
                     "random11": (11, 3)}[kind]
        return random_graph(m=120, avg_deg=deg, seed=seed)
    if kind == "cycle":
        n = 400
        return Graph(np.arange(n + 1), ((np.arange(n) + 1) % n)
                     .astype(np.int32))
    if kind == "chain":
        return _chain_of_2cycles()
    if kind == "trim2":
        return _trim2_chain()
    if kind == "rings":
        return _nested_cycles()
    return generate_graph("rmat", scale=10, symmetrize=False,
                          need_reverse=True)


@pytest.mark.parametrize("variant", ["color", "wcc"])
@pytest.mark.parametrize("kind", ["random0", "random1", "random4", "random11",
                                  "cycle", "chain", "trim2", "rings",
                                  "rmat10d"])
def test_scc_matches_jax_and_oracle(kind, variant):
    g = _scc_graph(kind)
    res = scc_solver(from_csr_of(g), variant=variant, device="cpu")
    want = jscc(g, variant=variant)
    root = res.scc_root.numpy()
    assert root.dtype == np.int32 and (root >= 0).all()
    assert same_components(root, np.asarray(want.scc_root))
    np.testing.assert_array_equal(root, np.asarray(want.scc_root))
    assert res.iterations == int(want.iterations)
    assert same_components(root, oracles.scc_serial(g))
    if kind == "cycle":
        assert len(np.unique(root)) == 1
    if kind == "trim2":
        assert len(np.unique(root)) == 10


def test_scc_max_rounds_and_unknown_variant():
    g = from_csr_of(_nested_cycles())
    assert scc_solver(g, device="cpu").iterations > 1
    res = scc_solver(g, max_rounds=1, device="cpu")
    assert res.iterations == 1 and bool((res.scc_root == -1).any())
    with pytest.raises(ValueError, match="unknown SCC variant"):
        scc_solver(g, variant="nope", device="cpu")


# --- clustering and random walks ---------------------------------------------

@pytest.mark.parametrize("weighted,threshold", [(False, 0.0), (False, 9.0),
                                                (True, 0.0), (True, 5.0),
                                                (True, 8.0), (True, 10.0)])
def test_cluster_threshold_matches_jax(weighted, threshold):
    g = random_graph(m=300, avg_deg=3, seed=2, weighted=weighted,
                     symmetric=True)
    res = cluster_threshold(from_csr_of(g), threshold, device="cpu")
    want = jcluster(g, threshold)
    np.testing.assert_array_equal(res.labels.numpy(), np.asarray(want.labels))
    assert res.num_clusters == want.num_clusters


def test_random_walks_follow_edges_and_their_seed():
    """Starts in column 0; every step an out-edge of the vertex before it,
    or a sink staying put; the same seed the same walks, another seed
    other walks."""
    g = random_graph(m=100, avg_deg=2, seed=4)
    tg = from_csr_of(g)
    starts = np.arange(100)
    walks = random_walks(tg, starts, 12, seed=3, device="cpu")
    assert walks.shape == (100, 13) and walks.dtype == torch.int32
    w = walks.numpy()
    np.testing.assert_array_equal(w[:, 0], starts)
    edges = set(zip(np.repeat(np.arange(g.m), np.diff(g.rowptr)).tolist(),
                    g.colidx.tolist()))
    deg = np.diff(g.rowptr)
    for a, b in zip(w[:, :-1].ravel(), w[:, 1:].ravel()):
        assert (a, b) in edges if deg[a] else a == b
    assert (deg == 0).any()
    assert torch.equal(walks, random_walks(tg, starts, 12, seed=3,
                                           device="cpu"))
    assert not torch.equal(walks, random_walks(tg, starts, 12, seed=4,
                                               device="cpu"))


def test_random_walks_pick_neighbours_uniformly():
    """20,000 walkers one step from the vertex of highest degree: each
    neighbour's count is Binomial(N, 1/d), held within 5 standard
    deviations of N/d."""
    g = generate_graph("rmat", scale=10, symmetrize=True)
    v = int(np.argmax(g.degrees))
    nbrs = g.colidx[g.rowptr[v]:g.rowptr[v + 1]]
    n, d = 20000, len(nbrs)
    step = random_walks(from_csr_of(g), np.full(n, v), 1, seed=11,
                        device="cpu")[:, 1].numpy()
    counts = np.bincount(step, minlength=g.m)[nbrs]
    assert counts.sum() == n
    sd = np.sqrt(n * (1 / d) * (1 - 1 / d))
    assert np.abs(counts - n / d).max() <= 5 * sd
