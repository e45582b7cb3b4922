"""The port's motif census (gardenia_tpu_torch.mining.motif) and its wedge
streams (mining/wedgestream) against the JAX package on the same
numpy-seeded graphs, on the CPU, exactly: the 3- and 4-census beside the
brute-force census, the streams' 4-cycle count c_non and per-edge
triangles tri_u at several partition budgets, a star, two hubs whose
codegree's pairs pass 2^32, the host partitions array by array, the host
oracles, and the branch to them when a partition is too large."""

import numpy as np
import pytest

from tests.conftest import random_graph

from gardenia_tpu.core import build as jbuild
from gardenia_tpu.core.graph import Graph
from gardenia_tpu.mining import motif as jmotif
from gardenia_tpu.mining import wedgestream as jws

from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.mining import motif, wedgestream as ws


def small(seed):
    return random_graph(m=28, avg_deg=6, seed=seed, symmetric=True)


def star(n) -> Graph:
    src = np.concatenate([np.zeros(n - 1, np.int64),
                          np.arange(1, n, dtype=np.int64)])
    dst = np.concatenate([np.arange(1, n, dtype=np.int64),
                          np.zeros(n - 1, np.int64)])
    rp, ci, _ = jbuild.coo_to_csr(n, src, dst, None, sorted_by_src=False)
    return Graph(rp, ci, None, num_cols=n, symmetric=True)


@pytest.fixture(scope="module")
def g300():
    """(JAX graph, its wedge_stream_stats at each budget)."""
    g = random_graph(m=300, avg_deg=12, seed=11, symmetric=True)
    return g, {b: jws.wedge_stream_stats(g, budget_slots=b)
               for b in (1 << 27, 1 << 14, 1 << 12)}


@pytest.mark.parametrize("seed", (0, 4))
@pytest.mark.parametrize("k", (3, 4))
def test_motif_solver_equals_jax_and_bruteforce(seed, k):
    g = small(seed)
    got = motif.motif_solver(from_csr_of(g), k, device="cpu")
    assert got == jmotif.motif_solver(g, k)
    assert got == motif.motif_census_bruteforce(from_csr_of(g), k)
    assert got == jmotif.motif_census_bruteforce(g, k)
    if k == 4:
        assert motif.LAST_AGGREGATES["aggregates"] == "streams"


@pytest.mark.parametrize("budget", (1 << 27, 1 << 14, 1 << 12))
def test_wedge_stream_stats_equal_jax(budget, g300):
    g, want = g300
    c_non, tri_u, ua, ub = ws.wedge_stream_stats(
        from_csr_of(g), budget_slots=budget, device="cpu")
    assert c_non == want[budget][0] > 0
    np.testing.assert_array_equal(tri_u, want[budget][1])
    assert ua is None and ub is None
    counts = ws.partition_counts(from_csr_of(g), budget)
    assert counts["n_parts"] > (1 if budget < 1 << 14 else 0)


def test_streams_equal_the_host_oracles(g300):
    g, want = g300
    pg = from_csr_of(g)
    tri = motif.edge_triangle_counts(pg, device="cpu")
    np.testing.assert_array_equal(tri, jmotif.edge_triangle_counts(g))
    src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    np.testing.assert_array_equal(want[1 << 27][1], tri[src < g.colidx])
    assert motif.codegree_cycle_quads(pg) == jmotif.codegree_cycle_quads(
        g) == want[1 << 27][0]
    assert motif.codegree_cycle_quads(pg, pass_budget=64) == want[1 << 27][0]


def test_star_has_no_triangle_and_no_cycle():
    g = star(12)
    c_non, tri_u, _, _ = ws.wedge_stream_stats(from_csr_of(g), device="cpu")
    assert c_non == jws.wedge_stream_stats(g)[0] == 0
    assert tri_u.sum() == 0 and len(tri_u) == 11
    assert motif.motif_solver(from_csr_of(g), 4, device="cpu") == \
        jmotif.motif_solver(g, 4)


def test_two_hubs_codegree_pairs_past_2_32():
    """Two hubs sharing 262,400 leaves: C(codeg, 2) = 34,426,748,800
    pairs, past 2^32, in int64 sums."""
    codeg = (1 << 18) + 256
    leaves = np.arange(2, 2 + codeg, dtype=np.int64)
    src = np.concatenate([np.zeros(codeg, np.int64),
                          np.ones(codeg, np.int64)])
    dst = np.concatenate([leaves, leaves])
    rp, ci, _ = jbuild.coo_to_csr(2 + codeg, np.concatenate([src, dst]),
                                  np.concatenate([dst, src]), None,
                                  sorted_by_src=False)
    g = Graph(rp, ci, None, num_cols=2 + codeg, symmetric=True)
    c_non, tri_u, _, _ = ws.wedge_stream_stats(from_csr_of(g), device="cpu")
    assert c_non == codeg * (codeg - 1) // 2 == 34_426_748_800 > 1 << 32
    assert tri_u.sum() == 0


def test_no_edge():
    g = star(1)
    c_non, tri_u, _, _ = ws.wedge_stream_stats(from_csr_of(g), device="cpu")
    assert c_non == 0 and tri_u.shape == (0,)


def flat(x) -> list:
    """The arrays and numbers of a nest of tuples, in order."""
    if isinstance(x, tuple):
        return [y for part in x for y in flat(part)]
    return [x]


def test_host_copies_equal_jax():
    """_relabel_edges, _host_partitions and _host_query_partitions give the
    reference's arrays, partition by partition."""
    assert ws.SEG_WIDTHS == jws.SEG_WIDTHS
    assert ws.WEDGE_PAYLOAD == jws.WEDGE_PAYLOAD
    assert ws.SENT_KEY == jws.SENT_KEY and ws.SENT_KEY.dtype == np.int32
    g = random_graph(m=120, avg_deg=10, seed=13, symmetric=True)
    pg = from_csr_of(g)
    mine, theirs = ws._relabel_edges(pg), jws._relabel_edges(g)
    for a, b in zip(mine[1:], theirs[1:]):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(mine[0].rowptr, theirs[0].rowptr)
    np.testing.assert_array_equal(mine[0].colidx, theirs[0].colidx)
    for budget in (1 << 27, 1 << 10):
        for fn in ("_host_partitions", "_host_query_partitions"):
            got = getattr(ws, fn)(mine[0], *mine[1:], budget)
            want = getattr(jws, fn)(theirs[0], *theirs[1:], budget)
            assert len(got) == len(want) > 0
            for p, q in zip(got, want):
                fp, fq = flat(p), flat(q)
                assert len(fp) == len(fq)
                for x, y in zip(fp, fq):
                    np.testing.assert_array_equal(x, y)
                    assert np.asarray(x).dtype == np.asarray(y).dtype


def test_oversized_partition_takes_the_host_oracles(monkeypatch):
    """A partition past the port's MAX_PART_SLOTS raises StreamTooLarge (a
    ValueError), and motif_solver counts with the host oracles, to the
    same census."""
    g = small(4)
    monkeypatch.setattr(ws, "MAX_PART_SLOTS", 8)
    with pytest.raises(ws.StreamTooLarge, match="partition"):
        ws.wedge_stream_stats(from_csr_of(g), device="cpu")
    got = motif.motif_solver(from_csr_of(g), 4, device="cpu")
    assert motif.LAST_AGGREGATES["aggregates"] == "host_oracles"
    assert got == jmotif.motif_solver(g, 4) == \
        jmotif.motif_census_bruteforce(g, 4)
    tri_sum = motif.LAST_AGGREGATES["tri_sum"]
    t3 = motif.motif_solver(from_csr_of(g), 3, device="cpu")["3-triangle"]
    assert tri_sum == 3 * t3 > 0


def test_other_value_errors_of_the_streams_propagate(monkeypatch):
    """Only StreamTooLarge sends the census to the host oracles: any other
    ValueError raised inside the streams reaches the caller."""
    def broken(*args, **kwargs):
        raise ValueError("not a size limit")
    monkeypatch.setattr(ws, "motif4_aggregates", broken)
    motif.LAST_AGGREGATES = None
    with pytest.raises(ValueError, match="not a size limit"):
        motif.motif_solver(from_csr_of(small(4)), 4, device="cpu")
    assert motif.LAST_AGGREGATES is None


def test_motif_solver_refuses_k_5():
    with pytest.raises(ValueError):
        motif.motif_solver(from_csr_of(small(0)), 5, device="cpu")
