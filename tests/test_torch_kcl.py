"""The port's k-clique counting (gardenia_tpu_torch.mining.kcl) against the
JAX package's kcl_solver and kcl_verifier on the same numpy-seeded graphs,
on the CPU, exactly: k = 3 (through tc_solver and, with force_expand,
through the expansion), 4, 5 and 6.  Kernel Q1's wrapper (ops/kcl_count)
takes its plain version here, the level expansion, whose per-vertex
counts are held to a per-vertex serial DFS; the host copies (wedge_slices,
_member) are held to the JAX package's; edge cases (no edge, cliques, a
star, the route at out-degree 1024 and 1025 and at k = 9) and the checks
of the wrapper's set-up."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import random_graph

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.mining import kcl as jkcl

from gardenia_tpu_torch.core import build
from gardenia_tpu_torch.core.graph import Graph, from_csr_of
from gardenia_tpu_torch.mining import kcl
from gardenia_tpu_torch.ops import kcl_count

GRAPHS = {
    "random70": lambda: random_graph(m=70, avg_deg=8, seed=1,
                                     symmetric=True),
    "rmat8": lambda: generate_graph("rmat", scale=8, symmetrize=True),
}
KS = (3, 4, 5, 6)


@pytest.fixture(scope="module")
def jax_counts():
    """{(graph, k): (JAX kcl_solver, kcl_verifier)}, computed once."""
    out = {}
    for name, make in GRAPHS.items():
        g = make()
        for k in KS:
            out[name, k] = (jkcl.kcl_solver(g, k), jkcl.kcl_verifier(g, k))
    return out


def edges_graph(n, a, b) -> Graph:
    """The port's symmetric Graph of n vertices over the undirected pairs
    (a[i], b[i])."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    rp, ci, _ = build.coo_to_csr(n, np.concatenate([a, b]),
                                 np.concatenate([b, a]), None,
                                 sorted_by_src=False)
    return Graph(rp, ci, num_cols=n, symmetric=True)


def clique(n):
    a, b = np.triu_indices(n, 1)
    return edges_graph(n, a, b)


def biclique(n):
    """K_{n,n}: every vertex of degree n, so vertex 0 keeps all n arcs in
    the degree-then-id DAG; no triangle."""
    a, b = np.divmod(np.arange(n * n), n)
    return edges_graph(2 * n, a, n + b)


def per_vertex_dfs(g, k) -> np.ndarray:
    """The k-cliques by their first DAG vertex, by a serial DFS (the
    verifier's, kept per vertex)."""
    dag = g.oriented()
    rp, ci = dag.rowptr, dag.colidx
    neigh = [set(ci[rp[v]:rp[v + 1]].tolist()) for v in range(dag.m)]

    def extend(cands, depth):
        if depth == k:
            return len(cands)
        return sum(extend(cands & neigh[x], depth + 1) for x in cands)
    return np.array([extend(neigh[v], 2) for v in range(dag.m)], np.int64)


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("k", KS)
def test_kcl_solver_equals_jax(name, k, jax_counts):
    want, verified = jax_counts[name, k]
    assert want == verified
    g = from_csr_of(GRAPHS[name]())
    assert kcl.kcl_solver(g, k, device="cpu") == want
    assert kcl.LAST_ROUTE == ("tc" if k == 3 else "q1_plain")
    if k == 3:
        assert kcl.kcl_solver(g, 3, force_expand=True, device="cpu") == want
        assert kcl.LAST_ROUTE == "q1_plain"


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("k", (3, 4, 5))
def test_plain_per_vertex_counts(name, k, jax_counts):
    """Q1's plain version gives each clique to its first vertex: per
    vertex equal to a serial DFS, summing to the JAX package's total."""
    g = from_csr_of(GRAPHS[name]())
    cnt = kcl_count.local_count(kcl.local_dag(g, "cpu"), k)
    assert cnt.dtype == torch.int64 and cnt.shape == (g.m,)
    np.testing.assert_array_equal(cnt.numpy(), per_vertex_dfs(g, k))
    assert int(cnt.sum()) == jax_counts[name, k][0]


def test_expansion_slices_and_steps(monkeypatch, jax_counts):
    """Slices of a few wedges and steps of fewer give the same counts
    (the multi-slice path of every level)."""
    g = from_csr_of(GRAPHS["random70"]())
    monkeypatch.setattr(kcl, "EMB_WEDGE_LIMIT", 64)
    for k in (3, 4, 5):
        got = kcl.expand_counts(*kcl.local_dag(g, "cpu")[:2], k, chunk=7)
        assert int(got.sum()) == jax_counts["random70", k][0]


@pytest.mark.parametrize("limit", (1, 5, 64, 10 ** 6))
def test_wedge_slices_equal_jax(limit):
    counts = np.random.default_rng(limit).integers(0, 40, 300)
    assert kcl.wedge_slices(counts, limit) == jkcl.wedge_slices(counts, limit)
    assert kcl.wedge_slices(np.zeros(0, np.int64), limit) == []


def test_member_equals_jax():
    g = GRAPHS["rmat8"]()
    rng = np.random.default_rng(5)
    rows = rng.integers(0, g.m, 4000).astype(np.int32)
    # half the queries drawn from the row itself, half at random
    deg = np.diff(g.rowptr)
    own = np.where(deg[rows] > 0, g.colidx[np.minimum(
        g.rowptr[rows] + rng.integers(0, 1 << 20, 4000) % np.maximum(
            deg[rows], 1), g.nnz - 1)], 0)
    queries = np.where(rng.random(4000) < 0.5, own,
                       rng.integers(0, g.m, 4000)).astype(np.int32)
    want = np.asarray(jkcl._member(
        jnp.asarray(g.rowptr.astype(np.int32)), jnp.asarray(g.colidx),
        g.nnz, jnp.asarray(queries), jnp.asarray(rows)))
    got = kcl._member(torch.from_numpy(g.rowptr.astype(np.int64)),
                      torch.from_numpy(g.colidx), g.nnz,
                      torch.from_numpy(queries), torch.from_numpy(rows),
                      kcl.search_rounds(deg.max()))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < len(want)


def test_no_edge_gives_zero():
    g = edges_graph(5, [], [])
    for k in (3, 4, 9):
        assert kcl.kcl_solver(g, k, force_expand=True, device="cpu") == 0


@pytest.mark.parametrize("n", (4, 9))
def test_clique_gives_binomial(n):
    g = clique(n)
    for k in range(3, 8):
        assert kcl.kcl_solver(g, k, force_expand=True,
                              device="cpu") == math.comb(n, k)


def test_star_gives_zero():
    g = edges_graph(40, np.zeros(39), np.arange(1, 40))
    for k in (3, 4, 5):
        assert kcl.kcl_solver(g, k, force_expand=True, device="cpu") == 0


@pytest.mark.parametrize("n,route", [(1024, "q1"), (1025, "expand")])
def test_route_at_out_degree_1024_and_1025(n, route):
    """Q1 takes out-degrees up to 1024: K_{1024,1024} goes to Q1,
    K_{1025,1025} to the expansion, chosen from the shape alone; on the
    CPU the Q1 route reports that its wrapper ran the plain version."""
    g = biclique(n)
    assert kcl.local_dag(g, "cpu").max_degree == n
    assert kcl.kcl_solver(g, 4, device="cpu") == 0
    assert kcl.LAST_ROUTE == {"q1": "q1_plain"}.get(route, route)
    assert kcl_count.route(n, 4) == route


def test_route_at_k_9():
    g = clique(10)
    assert kcl.kcl_solver(g, 8, device="cpu") == 45
    assert kcl.LAST_ROUTE == "q1_plain"
    assert kcl.kcl_solver(g, 9, device="cpu") == 10
    assert kcl.LAST_ROUTE == "expand"
    assert kcl_count.route(1, 9) == kcl_count.route(1, 2) == "expand"


def test_class_slices_cover_each_vertex_once():
    """The runs Q1 launches on hold every vertex with d >= k - 1 once, in
    the class of its degree."""
    g = from_csr_of(GRAPHS["rmat8"]())
    ldag = kcl.local_dag(g, "cpu")
    deg = (ldag.rowptr[1:] - ldag.rowptr[:-1]).numpy()
    for k in (3, 5, 8):
        seen = []
        for first, end, dmax in kcl_count.class_slices(ldag, k):
            verts = ldag.order[first:end].numpy()
            lower = kcl_count.CLASSES[kcl_count.CLASSES.index(dmax) - 1] \
                if dmax > kcl_count.CLASSES[0] else 0
            assert ((deg[verts] > lower) & (deg[verts] <= dmax)).all()
            seen.append(verts)
        seen = np.sort(np.concatenate(seen))
        np.testing.assert_array_equal(seen, np.flatnonzero(deg >= k - 1))


def test_prepare_refuses_what_q1_cannot_search():
    rowptr = torch.tensor([0, 2, 3], dtype=torch.int64)
    with pytest.raises(ValueError, match="ascending"):
        kcl_count.prepare(rowptr, torch.tensor([2, 1, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="ascending"):
        kcl_count.prepare(rowptr, torch.tensor([1, 1, 0], dtype=torch.int32))
    with pytest.raises(TypeError):
        kcl_count.prepare(rowptr, torch.tensor([1, 2, 0], dtype=torch.int64))
    with pytest.raises(ValueError, match="offsets"):
        kcl_count.prepare(torch.tensor([0, 2, 4]),
                          torch.tensor([1, 2, 0], dtype=torch.int32))
    ldag = kcl_count.prepare(rowptr, torch.tensor([1, 2, 0],
                                                  dtype=torch.int32))
    assert ldag.max_degree == 2 and ldag.order.tolist() == [1, 0]


def test_kcl_solver_refuses_k_below_3_and_defaults_to_cuda():
    g = clique(4)
    with pytest.raises(ValueError):
        kcl.kcl_solver(g, 2, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        kcl.kcl_solver(g, 4)
