"""The port's SSSP (gardenia_tpu_torch.solvers.sssp and sssp_nf) against
the JAX solvers and the serial Dijkstra on the same numpy-seeded graphs,
on the CPU: distances exactly equal, and `iterations` equal to the JAX
solver's, variant by variant and delta by delta."""

import numpy as np
import pytest
import torch

from tests.conftest import random_graph

from gardenia_tpu.core import types as T
from gardenia_tpu.core.generate import generate_graph, grid_edges
from gardenia_tpu.core.graph import from_edges
from gardenia_tpu.solvers.sssp import sssp_solver as jsssp
from gardenia_tpu.solvers.sssp_nf import _default_caps as jcaps
from gardenia_tpu.solvers.sssp_nf import sssp_nearfar as jnearfar
from gardenia_tpu.verify import oracles

from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.solvers import sssp as tsssp
from gardenia_tpu_torch.solvers import sssp_nf as tnf


def _graph(kind):
    if kind == "sym":
        return random_graph(m=130, avg_deg=5, seed=3, weighted=True,
                            symmetric=True)
    if kind == "directed":      # some vertices unreachable from 0
        return random_graph(m=90, avg_deg=2, seed=9, weighted=True)
    if kind == "grid":
        return from_edges(grid_edges(24), symmetrize=True, need_reverse=True)
    return generate_graph("rmat", scale=10, symmetrize=True,
                          weighted=kind == "rmat10w")


KINDS = ["sym", "directed", "grid", "rmat10w", "rmat10"]


def _same(res_t, res_j, want):
    dist = res_t.dist.numpy()
    assert dist.dtype == np.int32
    np.testing.assert_array_equal(dist, np.asarray(res_j.dist))
    np.testing.assert_array_equal(dist, want)
    assert res_t.iterations == int(res_j.iterations)


@pytest.mark.parametrize("delta", [1, 8, 64])
@pytest.mark.parametrize("variant", ["delta", "bf", "hybrid", "nearfar"])
@pytest.mark.parametrize("kind", KINDS)
def test_sssp_matches_jax_and_oracle(kind, variant, delta):
    g = _graph(kind)
    want = oracles.sssp_serial(g, 0)
    if kind == "directed":
        assert (want == T.MYINFINITY).any()
    res_t = tsssp.sssp_solver(from_csr_of(g), 0, delta, variant=variant,
                              device="cpu")
    _same(res_t, jsssp(g, 0, delta, variant=variant), want)


@pytest.mark.parametrize("q_cap,delta", [(2, 4), (2, 1), (8, 16)])
def test_sssp_nearfar_overflow_matches_jax(q_cap, delta, monkeypatch):
    """A tiny near queue forces the overflow path (dense rebuilds);
    distances and rounds still equal the JAX solver's."""
    g = random_graph(m=200, avg_deg=6, seed=5, weighted=True, symmetric=True)
    rebuilds = []
    dense = tsssp.Relaxer.dense
    monkeypatch.setattr(tsssp.Relaxer, "dense",
                        lambda self, *a: (rebuilds.append(1),
                                          dense(self, *a))[1])
    res_t = tnf.sssp_nearfar(from_csr_of(g), 0, delta, q_cap=q_cap,
                             device="cpu")
    _same(res_t, jnearfar(g, 0, delta, q_cap=q_cap),
          oracles.sssp_serial(g, 0))
    assert rebuilds


def test_sssp_nearfar_caps_are_the_jax_packages():
    for m, nnz in ((1, 0), (576, 2208), (1 << 20, 4190208), (1 << 24, 10)):
        assert tnf._default_caps(m, nnz) == jcaps(m, nnz)


def test_sssp_bucket_rounds_take_both_branches(monkeypatch):
    """R-MAT-10 at delta 64 takes sparse and dense rounds; the port's
    rounds and distances equal the JAX solver's (above), and here each
    branch is seen to run."""
    g = _graph("rmat10w")
    seen = {"sparse": 0, "dense": 0}
    for name in seen:
        fn = getattr(tsssp.Relaxer, name)

        def logged(self, *a, _fn=fn, _name=name):
            seen[_name] += 1
            return _fn(self, *a)
        monkeypatch.setattr(tsssp.Relaxer, name, logged)
    res = tsssp.sssp_solver(from_csr_of(g), 0, 64, device="cpu")
    assert seen["sparse"] and seen["dense"]
    assert seen["sparse"] + seen["dense"] == res.iterations


def test_sssp_max_rounds_and_unknown_variant():
    g = from_csr_of(_graph("grid"))
    res = tsssp.sssp_solver(g, 0, 1, variant="bf", max_rounds=3,
                            device="cpu")
    assert res.iterations == 3
    assert int(res.dist[0]) == 0 and bool((res.dist == T.MYINFINITY).any())
    with pytest.raises(ValueError, match="unknown SSSP variant"):
        tsssp.sssp_solver(g, 0, variant="nope", device="cpu")


def test_sssp_hybrid_honours_max_rounds():
    """'hybrid' stops at max_rounds as 'bf' and 'delta' do; without it,
    it runs until the buckets drain."""
    g = from_csr_of(_graph("grid"))
    full = tsssp.sssp_solver(g, 0, 1, variant="hybrid", device="cpu")
    assert full.iterations > 3
    res = tsssp.sssp_solver(g, 0, 1, variant="hybrid", max_rounds=3,
                            device="cpu")
    assert res.iterations == 3
    assert bool((res.dist == T.MYINFINITY).any())
