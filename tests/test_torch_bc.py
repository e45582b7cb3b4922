"""The port's Brandes BC (gardenia_tpu_torch.solvers.bc) against the JAX
solvers and the serial oracle on the same generated graphs, both on the
CPU.  Tolerance, everywhere: |a - b| <= 1e-4 * (|a| + |b|) + 1e-4 on
scores normalized to a max of 1, the check of the reference's CLI
(gardenia_tpu/cli.py:151-154): the two packages sum f32 path counts and
dependencies in different orders.  Iteration counts (forward levels) are
equal."""

import numpy as np
import pytest

from tests.conftest import random_graph

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.core.graph import from_edges
from gardenia_tpu.core.io import EdgeListData
from gardenia_tpu.solvers import bc as jbc
from gardenia_tpu.verify import oracles

from gardenia_tpu_torch.cli import bc_close
from gardenia_tpu_torch.core import views
from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.ops import panel as tpanel
from gardenia_tpu_torch.solvers import bc as tbc


def _islands():
    """Two components (vertices 0..149 and 150..249) and 50 isolated
    vertices."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 150, (2, 600))
    b = rng.integers(150, 250, (2, 300))
    src, dst = np.concatenate([a, b], axis=1).astype(np.int32)
    return from_edges(EdgeListData(300, 300, src, dst, None),
                      symmetrize=True)


def _graph(kind):
    if kind == "rmat10":
        return generate_graph("rmat", scale=10, symmetrize=True)
    if kind == "uniform10":
        return generate_graph("uniform", scale=10, symmetrize=True)
    if kind == "directed10":
        return generate_graph("rmat", scale=10, degree=8, symmetrize=False,
                              need_reverse=True)
    if kind == "islands":
        return _islands()
    return random_graph(m=90, avg_deg=5, seed=3, symmetric=True)


def _brandes_delta(g, s):
    """Brandes' dependencies from source s (source level included), in
    float64 and not normalized: the serial algorithm of oracles.bc_serial,
    which normalizes each source and so cannot be summed over sources."""
    from collections import deque
    depth = np.full(g.m, -1)
    sigma = np.zeros(g.m)
    depth[s], sigma[s] = 0, 1
    order, q = [], deque([s])
    while q:
        u = q.popleft()
        order.append(u)
        for v in g.colidx[g.rowptr[u]:g.rowptr[u + 1]]:
            if depth[v] < 0:
                depth[v] = depth[u] + 1
                q.append(v)
            if depth[v] == depth[u] + 1:
                sigma[v] += sigma[u]
    delta = np.zeros(g.m)
    for u in reversed(order):
        for v in g.colidx[g.rowptr[u]:g.rowptr[u + 1]]:
            if depth[v] == depth[u] + 1:
                delta[u] += sigma[u] / sigma[v] * (1.0 + delta[v])
    return delta


def _multi_oracle(g, sources):
    total = sum(_brandes_delta(g, int(s)) for s in sources)
    return (total / max(total.max(), 1e-30)).astype(np.float32)


def test_multi_oracle_is_the_serial_oracle_for_one_source():
    g = _graph("rmat10")
    s = int(np.argmax(g.degrees))
    np.testing.assert_allclose(_multi_oracle(g, [s]),
                               oracles.bc_serial(g, s), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["rmat10", "uniform10", "directed10",
                                  "islands"])
def test_bc_solver_matches_jax_and_oracle(kind):
    g = _graph(kind)
    s = int(np.argmax(g.degrees))
    res = tbc.bc_solver(from_csr_of(g), s, device="cpu")
    res_j = jbc.bc_solver(g, s)
    scores = res.scores.numpy()
    assert scores.shape == (g.m,) and scores.dtype == np.float32
    assert bc_close(scores, np.asarray(res_j.scores))
    assert bc_close(scores, oracles.bc_serial(g, s))
    assert res.iterations == int(res_j.iterations)
    assert scores.max() == 1.0


@pytest.mark.parametrize("layout", ["hybrid", "ell"])
@pytest.mark.parametrize("kind,S", [("small", 4), ("small", 16),
                                    ("rmat10", 16), ("directed10", 4),
                                    ("islands", 4)])
def test_bc_batched_matches_jax_and_oracle(kind, S, layout):
    g = _graph(kind)
    sources = (np.arange(S) * 5) % g.m
    res = tbc.bc_batched(from_csr_of(g), sources, layout=layout,
                         device="cpu")
    res_j = jbc.bc_batched(g, sources, layout=layout)
    scores = res.scores.numpy()
    assert scores.shape == (g.m,)
    assert bc_close(scores, np.asarray(res_j.scores))
    assert bc_close(scores, _multi_oracle(g, sources))
    assert res.iterations == int(res_j.iterations)
    assert not any(tpanel.LAUNCHES.values())     # on the CPU: plain only


def test_bc_batched_one_source_equals_single_source_solver():
    g = from_csr_of(_graph("rmat10"))
    s = int(np.argmax(g.degrees))
    one = tbc.bc_solver(g, s, device="cpu")
    for layout in ("hybrid", "ell"):
        res = tbc.bc_batched(g, [s], layout=layout, device="cpu")
        assert bc_close(res.scores.numpy(), one.scores.numpy())
        assert res.iterations == one.iterations


def test_bc_solver_num_sources_takes_the_batched_path(monkeypatch):
    """num_sources > 1: consecutive sources from `source`, wrapping, through
    bc_batched, as the reference's bc_solver."""
    g = from_csr_of(_graph("small"))
    seen = []
    batched = tbc.bc_batched
    monkeypatch.setattr(tbc, "bc_batched", lambda g_, sources, **kw: (
        seen.append(list(sources)), batched(g_, sources, **kw))[1])
    res = tbc.bc_solver(g, 88, num_sources=4, device="cpu")
    assert seen == [[88, 89, 0, 1]]
    assert bc_close(res.scores.numpy(), _multi_oracle(g, seen[0]))


def test_bc_symmetric_graph_shares_one_layout():
    """A symmetric graph's in- and out-layouts are one cache entry; a
    directed graph's are two."""
    for kind, same in (("small", True), ("directed10", False)):
        g = from_csr_of(_graph(kind))
        _, h_in, _ = views.relabeled_hybrid(g, "cpu")
        _, h_out, _ = views.relabeled_hybrid(g, "cpu", reverse=False)
        assert (h_in is h_out) == same
        rows, cols = views.coo_sorted(g, "cpu")
        assert (rows[1:] >= rows[:-1]).all() and len(cols) == g.nnz
        assert (views.coo_sorted(g, "cpu", reverse=True)[0] is rows) == same
