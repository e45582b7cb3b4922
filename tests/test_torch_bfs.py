"""The port's BFS (gardenia_tpu_torch.solvers.bfs) against the JAX solvers
and the serial oracle on the same generated graphs, both on the CPU:
depths and iteration counts exactly equal, the fused variant taking the
JAX solver's branch at every level, and multi-source BFS column by column.
The JAX side is asked for its layouts explicitly ("auto" resolves to "ell"
off the TPU); its Pallas matmul stays off on the CPU, as in its own tests.
"""

import numpy as np
import pytest
import torch

from tests.conftest import random_graph

from gardenia_tpu.core.generate import generate_graph
from gardenia_tpu.core.graph import from_edges
from gardenia_tpu.core.io import EdgeListData
from gardenia_tpu.solvers import bfs as jbfs
from gardenia_tpu.verify import oracles

from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.ops import panel as tpanel
from gardenia_tpu_torch.solvers import bfs as tbfs


def _islands():
    """Two components (vertices 0..149 and 150..249, the second never
    reached from the first) and 50 isolated vertices."""
    rng = np.random.default_rng(4)
    a = rng.integers(0, 150, (2, 600))
    b = rng.integers(150, 250, (2, 300))
    src, dst = np.concatenate([a, b], axis=1).astype(np.int32)
    return from_edges(EdgeListData(300, 300, src, dst, None),
                      symmetrize=True)


def _graph(kind):
    if kind == "rmat12":
        return generate_graph("rmat", scale=12, symmetrize=True)
    if kind == "rmat10":
        return generate_graph("rmat", scale=10, symmetrize=True)
    if kind == "uniform10":
        return generate_graph("uniform", scale=10, symmetrize=True)
    if kind == "directed10":
        return generate_graph("rmat", scale=10, degree=8, symmetrize=False,
                              need_reverse=True)
    return _islands()


KINDS = ["rmat12", "uniform10", "directed10", "islands"]


def _source(g):
    return int(np.argmax(g.degrees))


def _same(res_t, res_j, want):
    dist = res_t.dist.numpy()
    assert dist.dtype == np.int32
    np.testing.assert_array_equal(dist, np.asarray(res_j.dist))
    np.testing.assert_array_equal(dist, want)
    assert res_t.iterations == int(res_j.iterations)


@pytest.mark.parametrize("layout", ["hybrid", "ell"])
@pytest.mark.parametrize("kind", KINDS)
def test_bfs_pull_matches_jax_and_oracle(kind, layout):
    g = _graph(kind)
    s = _source(g)
    res = tbfs.bfs_pull(from_csr_of(g), s, layout=layout, device="cpu")
    _same(res, jbfs.bfs_pull(g, s, layout=layout), oracles.bfs_serial(g, s))
    # pull runs until a level discovers nothing: eccentricity + 1 levels
    reached = res.dist.numpy()[res.dist.numpy() < tbfs.INF]
    assert res.iterations == reached.max() + 1
    assert not any(tpanel.LAUNCHES.values())     # on the CPU: plain only


@pytest.mark.parametrize("kind", KINDS)
def test_bfs_do_matches_jax_and_oracle(kind):
    g = _graph(kind)
    s = _source(g)
    res = tbfs.bfs_do(from_csr_of(g), s, device="cpu")
    _same(res, jbfs.bfs_do(g, s), oracles.bfs_serial(g, s))


def _jax_branches(g, dist, tiers):
    """The lax.switch index the JAX solver takes at every level, from its
    depths: scout = the level's out-edges, work_bu = the in-edges of the
    rows unvisited when the level starts (bfs.py:322-341).  Vertex sets,
    so the relabelling of the hybrid layout does not matter."""
    deg = np.asarray(g.degrees, np.int64)
    deg_in = np.asarray(g.in_degrees, np.int64)
    out = []
    d = 0
    while (dist == d).any():
        scout = deg[dist == d].sum()
        work_bu = deg_in[dist > d].sum()          # unreached: MYINFINITY
        idx = sum(scout > ce for _, ce in tiers)
        if idx == len(tiers):
            idx += sum(work_bu > ce for _, ce in tiers)
        out.append(int(idx))
        d += 1
    return out


@pytest.mark.parametrize("layout", ["hybrid", "ell"])
@pytest.mark.parametrize("kind", KINDS)
def test_bfs_do_fused_matches_jax_level_by_level(kind, layout, monkeypatch):
    g = _graph(kind)
    s = _source(g)
    taken = []
    pick = tbfs._pick_branch
    monkeypatch.setattr(tbfs, "_pick_branch", lambda *a: (
        taken.append(pick(*a)), taken[-1])[1])
    res = tbfs.bfs_do_fused(from_csr_of(g), s, layout=layout, device="cpu")
    res_j = jbfs.bfs_do_fused(g, s, layout=layout)
    _same(res, res_j, oracles.bfs_serial(g, s))
    tiers = tbfs.fused_tiers(g.m, g.nnz)
    assert taken == _jax_branches(g, np.asarray(res_j.dist), tiers)
    assert len(taken) == res.iterations


def test_bfs_do_fused_tiers_and_branch_kinds():
    """The tier rule of bfs.py:248-274 on known sizes, and an R-MAT-12
    traversal from its hub that takes a top-down level, the dense sweep
    and a sparse bottom-up level."""
    assert tbfs.fused_tiers(1 << 20, 31_404_232) == [
        (8192, 8192), (65536, 65536), (524288, 524288)]
    assert tbfs.fused_tiers(1024, 21_206) == [(1024, 1024), (1024, 2048)]
    g = _graph("rmat12")
    tiers = tbfs.fused_tiers(g.m, g.nnz)
    n = len(tiers)
    dist = oracles.bfs_serial(g, _source(g))
    kinds = {"td" if i < n else "bu_sparse" if i < 2 * n else "bu_dense"
             for i in _jax_branches(g, dist, tiers)}
    assert kinds == {"td", "bu_sparse", "bu_dense"}


@pytest.mark.parametrize("variant", ["pull", "do", "do_fused"])
def test_bfs_solver_variants_and_isolated_source(variant):
    """bfs_solver's table, from a source without edges: one level (two for
    pull and do_fused's count: the level that finds nothing), every other
    vertex unreached."""
    g = _graph("islands")
    tg = from_csr_of(g)
    res = tbfs.bfs_solver(tg, 299, variant=variant, device="cpu")
    res_j = jbfs.bfs_solver(g, 299, variant=variant)
    _same(res, res_j, oracles.bfs_serial(g, 299))
    assert int((res.dist < tbfs.INF).sum()) == 1
    with pytest.raises(ValueError):
        tbfs.bfs_solver(tg, 0, variant="nope", device="cpu")
    with pytest.raises(ValueError):
        tbfs.bfs_pull(tg, 0, layout="csr", device="cpu")


@pytest.mark.parametrize("layout", ["hybrid", "ell"])
@pytest.mark.parametrize("kind,S", [("rmat10", 16), ("directed10", 3),
                                    ("islands", 9)])
def test_msbfs_matches_jax_and_single_source(kind, S, layout):
    """bfs_multi_source exactly equal to the JAX package's and, column by
    column, to the serial oracle (tests/test_batched.py:70-104)."""
    g = _graph(kind)
    sources = (np.arange(S) * 37) % g.m
    res = tbfs.bfs_multi_source(from_csr_of(g), sources, layout=layout,
                                device="cpu")
    res_j = jbfs.bfs_multi_source(g, sources, layout=layout)
    dist = res.dist.numpy()
    assert dist.shape == (g.m, S) and dist.dtype == np.int32
    np.testing.assert_array_equal(dist, np.asarray(res_j.dist))
    assert res.iterations == int(res_j.iterations)
    for j, s in enumerate(sources):
        np.testing.assert_array_equal(dist[:, j],
                                      oracles.bfs_serial(g, int(s)))


def test_msbfs_128_sources_hybrid():
    """The bench's shape in small: 128 sources on the hybrid layout, held
    to the single-source solver column by column."""
    g = from_csr_of(random_graph(m=700, avg_deg=6, seed=9, symmetric=True))
    sources = np.arange(128)
    res = tbfs.bfs_multi_source(g, sources, device="cpu")
    assert res.dist.shape == (700, 128)
    for j in (0, 1, 63, 127):
        one = tbfs.bfs_pull(g, int(sources[j]), layout="ell", device="cpu")
        assert torch.equal(res.dist[:, j], one.dist)
