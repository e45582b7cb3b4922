"""The port's vertex colouring (gardenia_tpu_torch.solvers.vc) against the
JAX solver on the same numpy-seeded graphs, on the CPU: colours,
num_colors and iterations exactly equal in every tier (dense, sparse with
spills, core, the hand-off to the core, palette escalation and core
saturation), each tier forced by setting the same module constants in
both packages.  Every colouring is also held to oracles.vc_check.  The
core pass's sequential first-fit (ops/vc_core, kernel V1's plain version
here) is held to a numpy greedy on hand-made cases."""

import numpy as np
import pytest
import torch

from tests.conftest import random_graph

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.core.graph import Graph
from gardenia_tpu.solvers import vc as jvc
from gardenia_tpu.verify import oracles

from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.ops import vc_core
from gardenia_tpu_torch.solvers import vc


def clique(n: int) -> Graph:
    dst = np.concatenate([[j for j in range(n) if j != i] for i in range(n)])
    rowptr = np.arange(n + 1, dtype=np.int64) * (n - 1)
    return Graph(rowptr, dst.astype(np.int32), symmetric=True)


GRAPHS = {
    "random180": lambda: random_graph(m=180, avg_deg=6, seed=3,
                                      symmetric=True),
    "random180d8": lambda: random_graph(m=180, avg_deg=8, seed=5,
                                        symmetric=True),
    "rmat10": lambda: generate_graph("rmat", scale=10, symmetrize=True),
    "uniform10": lambda: generate_graph("uniform", scale=10,
                                        symmetrize=True),
    "clique10": lambda: clique(10),
}

# tier -> (VC_SPARSE_CAPS, VC_CORE_CAP); None keeps the default
TIERS = {
    "core": (None, None),                        # the default at small m
    "dense": ((), 0),
    "sparse_spills": ((16,), 0),
    "sparse": ((256, 8192), 0),
    "handoff": (None, 16),
    "all_three": ((1 << 12, 1 << 14), 32),
}


def solve_both(monkeypatch, g, tier, max_color=128):
    caps, core = TIERS[tier]
    for mod in (jvc, vc):
        if caps is not None:
            monkeypatch.setattr(mod, "VC_SPARSE_CAPS", caps)
        if core is not None:
            monkeypatch.setattr(mod, "VC_CORE_CAP", core)
    # small segments make the JAX solver's spill-and-resume path run often
    want = jvc.vc_solver(g, max_color=max_color, rounds_per_segment=2)
    got = vc.vc_solver(from_csr_of(g), max_color=max_color, device="cpu")
    return want, got


def assert_same(want, got, g):
    colors = got.colors.numpy()
    np.testing.assert_array_equal(colors, np.asarray(want.colors))
    assert got.num_colors == int(want.num_colors)
    assert got.iterations == int(want.iterations)
    assert got.iterations == sum(got.rounds.values())
    assert got.colors.dtype == torch.int32
    assert oracles.vc_check(g, colors)


@pytest.mark.parametrize("tier", sorted(TIERS))
@pytest.mark.parametrize("graph", ["random180", "random180d8", "rmat10"])
def test_vc_matches_jax_in_every_tier(monkeypatch, graph, tier):
    g = GRAPHS[graph]()
    want, got = solve_both(monkeypatch, g, tier)
    assert_same(want, got, g)
    if tier in ("core", "handoff", "all_three"):
        assert got.rounds["core"] >= 1 and got.core_size > 0
    if tier in ("dense", "sparse_spills", "sparse"):
        assert got.rounds["core"] == 0
    if tier == "dense":
        assert got.rounds == {"dense": got.iterations, "sparse": 0,
                              "core": 0}


@pytest.mark.parametrize("tier", ["sparse", "all_three"])
def test_vc_sparse_rounds_run(monkeypatch, tier):
    """The sparse tier runs at all on R-MAT-10 under these caps (the other
    tests would pass with every round dense)."""
    g = GRAPHS["rmat10"]()
    want, got = solve_both(monkeypatch, g, tier)
    assert_same(want, got, g)
    assert got.rounds["sparse"] > 0 and got.rounds["dense"] > 0


@pytest.mark.parametrize("tier", ["core", "dense", "sparse", "all_three"])
@pytest.mark.parametrize("graph,max_color", [("clique10", 4),
                                             ("rmat10", 8),
                                             ("uniform10", 4)])
def test_vc_palette_escalation(monkeypatch, graph, max_color, tier):
    """A palette too small saturates vertices (in the core pass: core
    saturation and resume); both solvers double it and resume alike."""
    g = GRAPHS[graph]()
    want, got = solve_both(monkeypatch, g, tier, max_color=max_color)
    assert_same(want, got, g)
    assert got.palette > max_color
    if graph == "clique10":
        assert got.num_colors == 10


def test_vc_core_saturation_resume(monkeypatch):
    """K_10 with 4 colours inside the core pass: saturated members stay
    active and the next core pass, under the doubled palette, keeps every
    committed colour."""
    g = clique(10)
    want, got = solve_both(monkeypatch, g, "core", max_color=4)
    assert_same(want, got, g)
    assert got.rounds == {"dense": 0, "sparse": 0, "core": 3}
    assert got.palette == 16


def test_vc_remembers_its_palette():
    g = from_csr_of(GRAPHS["clique10"]())
    first = vc.vc_solver(g, max_color=4, device="cpu")
    assert not hasattr(g, "_vc_palette")        # only for the default
    g2 = from_csr_of(generate_graph("rmat", scale=8, symmetrize=True))
    a = vc.vc_solver(g2, device="cpu")
    assert g2._vc_palette == a.palette == 128
    b = vc.vc_solver(g2, device="cpu")
    assert torch.equal(a.colors, b.colors) and first.num_colors == 10


def test_vc_default_device_is_cuda():
    g = from_csr_of(GRAPHS["clique10"]())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        vc.vc_solver(g)


# --- ops/vc_core: the core pass's first-fit ---------------------------------

def greedy(forb: np.ndarray, adj: np.ndarray) -> np.ndarray:
    """The numpy sequential greedy over rows in order."""
    forb = forb.astype(bool).copy()
    out = np.full(len(forb), -1, np.int32)
    for i in range(len(forb)):
        free = np.flatnonzero(~forb[i])
        if free.size:
            out[i] = free[0]
            forb[np.flatnonzero(adj[i]), free[0]] = True
    return out


def csr(adj: np.ndarray):
    i, j = np.nonzero(adj)
    return vc_core.core_csr(torch.from_numpy(i), torch.from_numpy(j),
                            len(adj))


def _cases():
    rng = np.random.default_rng(7)
    sym = np.triu(rng.random((60, 60)) < 0.2, 1)
    sat = np.zeros((3, 4), np.int8)
    sat[0] = 1
    sat[1, [0, 1, 3]] = 1
    return {
        "K1": (np.zeros((1, 8), np.int8), np.zeros((1, 1), bool)),
        "saturated_row_C4": (sat, ~np.eye(3, dtype=bool)),
        "empty_adjacency": ((rng.random((50, 6)) < 0.6).astype(np.int8),
                            np.zeros((50, 50), bool)),
        "clique_wider_than_palette": (np.zeros((12, 8), np.int8),
                                      ~np.eye(12, dtype=bool)),
        "random": ((rng.random((60, 16)) < 0.3).astype(np.int8),
                   sym | sym.T),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_vc_core_plain_matches_numpy_greedy(name):
    forb, adj = _cases()[name]
    rowptr, col = csr(adj)
    t = torch.from_numpy(forb)
    got = vc_core.vc_core_firstfit(t, rowptr, col)
    np.testing.assert_array_equal(got.numpy(), greedy(forb, adj))
    assert torch.equal(t, torch.from_numpy(forb))    # forb is not modified
    assert vc_core.LAUNCHES == 0                     # no kernel on the CPU


def test_vc_core_csr_keeps_the_upper_part():
    rowptr, col = vc_core.core_csr(torch.tensor([0, 1, 1, 2, 2, 0]),
                                   torch.tensor([1, 0, 2, 1, 0, 2]), 4)
    assert rowptr.tolist() == [0, 2, 3, 3, 3]
    assert col.tolist() == [1, 2, 2] and col.dtype == torch.int32


def test_vc_core_wrapper_rejects_bad_arguments():
    forb = torch.zeros((3, 4), dtype=torch.int8)
    rowptr, col = torch.zeros(4, dtype=torch.int64), torch.zeros(
        0, dtype=torch.int32)
    with pytest.raises(TypeError):
        vc_core.vc_core_firstfit(forb.float(), rowptr, col)
    with pytest.raises(TypeError):
        vc_core.vc_core_firstfit(forb, rowptr.int(), col)
    with pytest.raises(TypeError):
        vc_core.vc_core_firstfit(forb, rowptr, col.long())
    with pytest.raises(ValueError):
        vc_core.vc_core_firstfit(forb, rowptr[:3], col)
    with pytest.raises(ValueError):
        vc_core.empty_steps(4, "cpu")
