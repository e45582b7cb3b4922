"""The port's subgraph listing (gardenia_tpu_torch.mining.sgl) and its
pattern engine (mining/pattern) against the JAX package on the same
numpy-seeded graphs, on the CPU, exactly: the four patterns beside both
packages' brute-force verifiers, diamond's formula against the engine and
on both branches of its per-edge triangles (the wedge streams and, where a
stream partition is too large, the wedge sweep), the engine at several
chunks and wedge-slice budgets, and edge cases (no edge, a star, a
triangle-free graph, an unknown pattern)."""

import numpy as np
import pytest

from tests.conftest import random_graph

from gardenia_tpu.core import build as jbuild
from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.core.graph import Graph
from gardenia_tpu.mining import kcl as jkcl
from gardenia_tpu.mining import sgl as jsgl
from gardenia_tpu.solvers import tc as jtc

from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.mining import motif, pattern, sgl, wedgestream

PATTERNS = ("diamond", "rectangle", "pentagon", "house")


def graph_of(n, src, dst) -> Graph:
    """The JAX package's symmetric Graph over the undirected edges."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    s = np.concatenate([src, dst])
    d = np.concatenate([dst, src])
    rp, ci, _ = jbuild.coo_to_csr(n, s, d, None, sorted_by_src=False)
    return Graph(rp, ci, None, num_cols=n, symmetric=True)


@pytest.fixture(scope="module")
def small():
    """(JAX graph, {pattern: its count by the JAX verifier})."""
    g = random_graph(m=16, avg_deg=4, seed=2, symmetric=True)
    return g, {p: jsgl.sgl_verifier(g, p) for p in PATTERNS}


@pytest.mark.parametrize("seed", (5, 9))
@pytest.mark.parametrize("name", PATTERNS)
def test_sgl_solver_equals_jax_and_bruteforce(name, seed):
    g = random_graph(m=26, avg_deg=5, seed=seed, symmetric=True)
    pg = from_csr_of(g)
    got = sgl.sgl_solver(pg, name, device="cpu")
    want = jsgl.sgl_verifier(g, name)
    assert got == jsgl.sgl_solver(g, name) == want > 0
    assert sgl.sgl_verifier(pg, name) == want
    route = "streams" if name == "diamond" else "engine"
    assert sgl.LAST_ROUTE["route"] == route


@pytest.mark.parametrize("seed", (6, 8))
def test_diamond_formula_equals_engine_and_jax(seed):
    g = random_graph(m=60, avg_deg=6, seed=seed, symmetric=True)
    pg = from_csr_of(g)
    formula = sgl.sgl_solver(pg, "diamond", device="cpu")
    last = sgl.LAST_ROUTE
    assert last["route"] == "streams" and last["kcl_route"] == "q1_plain"
    src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    tri = motif.edge_triangle_counts(pg, device="cpu")[src < g.colidx]
    assert last["tri_sum"] == int(tri.sum()) > 0
    engine = sgl.sgl_solver(pg, "diamond", use_formula=False, device="cpu")
    assert sgl.LAST_ROUTE == {"route": "engine", "kcl_route": None}
    assert formula == engine == jsgl.sgl_solver(g, "diamond") == \
        jsgl.sgl_solver(g, "diamond", use_formula=False) > 0


def test_diamond_takes_the_wedge_sweep_when_a_partition_is_too_large(
        monkeypatch):
    g = random_graph(m=60, avg_deg=6, seed=6, symmetric=True)
    want = jsgl.sgl_solver(g, "diamond")
    monkeypatch.setattr(wedgestream, "MAX_PART_SLOTS", 64)
    pg = from_csr_of(g)
    assert sgl.sgl_solver(pg, "diamond", device="cpu") == want > 0
    last = sgl.LAST_ROUTE
    assert last["route"] == "wedge_sweep"
    assert last["k4"] == jkcl.kcl_solver(g, 4) > 0
    assert last["tri_sum"] == 3 * jtc.tc_solver(g)


@pytest.mark.parametrize("chunk", (1, 7, 1 << 18))
def test_count_pattern_does_not_depend_on_chunk(chunk, small):
    g, want = small
    pg = from_csr_of(g)
    for name in PATTERNS:
        got = pattern.count_pattern(pg, pattern.PATTERNS[name], chunk=chunk,
                                    device="cpu")
        assert got == want[name], name


@pytest.mark.parametrize("limit,chunk", ((16, 4), (100, 1 << 23)))
def test_count_pattern_over_many_slices(monkeypatch, small, limit, chunk):
    """A small wedge budget cuts every level into many slices."""
    g, want = small
    monkeypatch.setattr(pattern, "EMB_WEDGE_LIMIT", limit)
    pg = from_csr_of(g)
    for name in PATTERNS:
        got = pattern.count_pattern(pg, pattern.PATTERNS[name], chunk=chunk,
                                    device="cpu")
        assert got == want[name], name


EDGE_CASES = {
    "edgeless": lambda: graph_of(12, [], []),
    "star": lambda: graph_of(9, np.zeros(8, np.int64), np.arange(1, 9)),
    # K_{3,4}: no triangle, C(3,2) C(4,2) = 18 induced 4-cycles
    "k34": lambda: graph_of(7, np.repeat(np.arange(3), 4),
                            np.tile(np.arange(3, 7), 3)),
}


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_edge_cases(case):
    g = EDGE_CASES[case]()
    pg = from_csr_of(g)
    for name in PATTERNS:
        got = sgl.sgl_solver(pg, name, device="cpu")
        assert got == jsgl.sgl_solver(g, name) == jsgl.sgl_verifier(g, name)
        assert got == (18 if (case, name) == ("k34", "rectangle") else 0)
    assert sgl.sgl_solver(pg, "diamond", use_formula=False,
                          device="cpu") == 0


def test_pattern_names_and_unknown_pattern():
    g = from_csr_of(random_graph(m=20, avg_deg=4, seed=3, symmetric=True))
    assert sgl.sgl_solver(g, "Diamond", device="cpu") == \
        sgl.sgl_solver(g, "DIAMOND", use_formula=False, device="cpu")
    assert sgl.sgl_solver(g, "House", device="cpu") == \
        sgl.sgl_verifier(g, "house")
    with pytest.raises(ValueError, match="unknown pattern"):
        sgl.sgl_solver(g, "hexagon", device="cpu")
    assert sorted(pattern.PATTERNS) == sorted(PATTERNS)


def test_rmat_diamond_and_rectangle_equal_the_census():
    """On a skewed graph the formula and the engine give the 4-census's
    diamonds, and the engine's induced rectangles are its 4-cycles."""
    g = generate_graph("rmat", scale=8, symmetrize=True)
    pg = from_csr_of(g)
    census = motif.motif_solver(pg, 4, device="cpu")
    assert sgl.sgl_solver(pg, "diamond", device="cpu") == \
        sgl.sgl_solver(pg, "diamond", use_formula=False, device="cpu") == \
        census["4-diamond"] == jsgl.sgl_solver(g, "diamond")
    assert sgl.sgl_solver(pg, "rectangle", device="cpu") == \
        census["4-cycle"] > 0


@pytest.mark.parametrize("name", ("pentagon", "house"))
def test_dense_products_of_the_smoke_test_count_fives(name):
    """chip_smoke.induced_fives, which holds the engine's R-MAT-10
    pentagons and houses on the card, gives the JAX package's counts and
    the brute force's, on a random graph and on a skewed one."""
    import chip_smoke
    g = random_graph(m=24, avg_deg=6, seed=11, symmetric=True)
    got = chip_smoke.induced_fives(from_csr_of(g), name, "cpu")
    assert got == jsgl.sgl_solver(g, name) == \
        jsgl.sgl_verifier(g, name) > 0
    g8 = generate_graph("rmat", scale=7, symmetrize=True)
    assert chip_smoke.induced_fives(from_csr_of(g8), name, "cpu") == \
        jsgl.sgl_solver(g8, name) > 0
