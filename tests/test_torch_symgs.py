"""The port's multi-colour symmetric Gauss-Seidel (gardenia_tpu_torch.
solvers.symgs) against the JAX solver on the same numpy-seeded Ax, x, b,
diag and colours, on the CPU, within rtol 1e-5 and atol 1e-6: both sweep
the same blocks in the same order in f32, the port row by row over a
colour-ordered CSR and the JAX package by masked ELL SpMVs, so only the
order of each row's sum differs.  Both are also held to the serial sweep
(oracles.symgs_serial) by the CLI's l2 error < 1e-4."""

import numpy as np
import pytest
import torch

from tests.conftest import random_graph

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.core.graph import Graph
from gardenia_tpu.solvers.symgs import symgs_solver as jsymgs
from gardenia_tpu.solvers.vc import vc_solver as jvc
from gardenia_tpu.verify import l2_error, oracles

from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.solvers import symgs


def isolated_graph() -> Graph:
    """A random graph with vertex 0 cut loose (no edges)."""
    g = random_graph(m=90, avg_deg=4, seed=6, symmetric=True)
    src = np.repeat(np.arange(g.m), np.diff(g.rowptr))
    keep = (src != 0) & (g.colidx != 0)
    rowptr = np.concatenate([[0], np.cumsum(np.bincount(src[keep],
                                                        minlength=g.m))])
    return Graph(rowptr.astype(np.int64), g.colidx[keep], symmetric=True)


GRAPHS = {
    "rmat10": lambda: generate_graph("rmat", scale=10, symmetrize=True),
    "random150": lambda: random_graph(m=150, avg_deg=5, seed=2,
                                      symmetric=True),
    "uniform9": lambda: generate_graph("uniform", scale=9, symmetrize=True),
    "isolated": isolated_graph,
}


def inputs(g, seed=13):
    rng = np.random.default_rng(seed)
    Ax = rng.random(g.nnz).astype(np.float32)
    x0 = rng.random(g.m).astype(np.float32)
    b = rng.random(g.m).astype(np.float32)
    diag = (g.degrees + 1).astype(np.float32)
    return Ax, x0, b, diag, np.asarray(jvc(g).colors)


def serial(g, Ax, x0, b, diag, colors):
    order = np.argsort(colors, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(np.bincount(colors))])
    return oracles.symgs_serial(g, order, Ax, diag, x0, b, offsets)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_symgs_matches_jax_and_serial(graph):
    g = GRAPHS[graph]()
    args = inputs(g)
    want = np.asarray(jsymgs(g, *args).x)
    res = symgs.symgs_solver(from_csr_of(g), *args, device="cpu")
    got = res.x.numpy()
    assert res.x.dtype == torch.float32 and got.shape == (g.m,)
    assert res.num_colors == int(args[-1].max()) + 1
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    expect = serial(g, *args)
    assert l2_error(got, expect) < 1e-4 and l2_error(want, expect) < 1e-4


def test_symgs_isolated_vertex_takes_b_over_diag():
    g = isolated_graph()
    Ax, x0, b, diag, colors = inputs(g)
    got = symgs.symgs_solver(from_csr_of(g), Ax, x0, b, diag, colors,
                             device="cpu").x.numpy()
    assert g.degrees[0] == 0 and got[0] == b[0] / diag[0]


def test_symgs_zero_diagonal_keeps_x():
    g = GRAPHS["random150"]()
    Ax, x0, b, diag, colors = inputs(g)
    diag = diag.copy()
    diag[::7] = 0
    want = np.asarray(jsymgs(g, Ax, x0, b, diag, colors).x)
    got = symgs.symgs_solver(from_csr_of(g), Ax, x0, b, diag, colors,
                             device="cpu").x.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(got[::7], x0[::7])


@pytest.mark.parametrize("graph", ["rmat10", "random150"])
def test_symgs_defaults_and_own_colouring(graph):
    """colors=None colours with the port's vc_solver (equal to the JAX
    package's), and the defaults draw Ax, x, b from default_rng(13)."""
    g = GRAPHS[graph]()
    want = jsymgs(g)
    got = symgs.symgs_solver(from_csr_of(g), device="cpu")
    assert got.num_colors == want.num_colors
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                               rtol=1e-5, atol=1e-6)


def test_symgs_caches_the_ordered_system_per_array():
    g = from_csr_of(GRAPHS["random150"]())
    Ax, x0, b, diag, colors = inputs(GRAPHS["random150"]())
    a = symgs.symgs_solver(g, Ax, x0, b, diag, colors, device="cpu")
    n = len(g._device_cache)
    c = symgs.symgs_solver(g, Ax, x0 * 2, b, diag, colors, device="cpu")
    assert len(g._device_cache) == n            # same arrays: reused
    symgs.symgs_solver(g, Ax.copy(), x0, b, diag, colors, device="cpu")
    assert len(g._device_cache) == n + 1        # new values: a new entry
    assert not torch.equal(a.x, c.x)


def test_color_ordered_blocks_are_contiguous_colours():
    g = GRAPHS["random150"]()
    Ax, _, b, diag, colors = inputs(g)
    sys = symgs.color_ordered(from_csr_of(g), Ax, b, diag, colors, "cpu")
    order = sys.order.numpy()
    deg = np.diff(g.rowptr)
    for r0, r1, offsets, e0, e1, _ in sys.blocks:
        assert len(set(colors[order[r0:r1]])) == 1
        np.testing.assert_array_equal(
            offsets.numpy(), np.concatenate([[0], np.cumsum(
                deg[order[r0:r1]])]))
        assert offsets[-1] == e1 - e0
    assert sys.blocks[-1][1] == g.m and sys.blocks[-1][4] == g.nnz
