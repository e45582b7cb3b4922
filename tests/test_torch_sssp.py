"""The port's SSSP (gardenia_tpu_torch.solvers.sssp and sssp_nf) against
the JAX solvers and the serial Dijkstra on the same numpy-seeded graphs,
on the CPU: distances exactly equal, and `iterations` equal to the JAX
solver's, variant by variant and delta by delta.  Also the min-plus sweep
of the distributed SSSP (ops/bsr.spmv_hybrid_min_plus, kernel M1's plain
version on CPU tensors) against the JAX package's, exactly."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.conftest import random_graph

from gardenia_tpu.core import types as T
from gardenia_tpu.core.generate import generate_graph, grid_edges
from gardenia_tpu.core.graph import Graph, from_edges
from gardenia_tpu.solvers.sssp import sssp_solver as jsssp
from gardenia_tpu.solvers.sssp_nf import _default_caps as jcaps
from gardenia_tpu.solvers.sssp_nf import sssp_nearfar as jnearfar
from gardenia_tpu.verify import oracles

from gardenia_tpu.ops import bsr as jbsr

from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.ops import bsr as tbsr
from gardenia_tpu_torch.ops import minselect as tminsel
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


# ---- the min-plus sweep (kernel M1's plain version) -----------------------

INF = int(T.MYINFINITY)
MINPLUS_WEIGHTS = {
    # name: (weights of each edge, the panels' dtype, the layout's scale)
    "int8": (lambda rng, nnz: rng.integers(1, 65, nnz), torch.int8, 1.0),
    "bf16": (lambda rng, nnz: rng.integers(128, 257, nnz), torch.bfloat16,
             1.0),
    "f32": (lambda rng, nnz: rng.integers(300, 5000, nnz), torch.float32,
            1.0),
    "uniform3": (lambda rng, nnz: np.full(nnz, 3), torch.int8, 3.0),
    "unweighted": (None, torch.int8, 1.0),
}


def _minplus_layouts(name, scale=None):
    """(port, JAX) hybrid layouts of a directed random graph (rows with no
    in-neighbours among them) under one weight kind; scale overrides the
    layout's."""
    full = random_graph(m=900, avg_deg=14, seed=7)
    deg = np.diff(full.rowptr)
    deg[::50] = 0                               # rows with no neighbour
    keep = np.repeat(deg > 0, np.diff(full.rowptr))
    g = Graph(np.concatenate([[0], np.cumsum(deg)]), full.colidx[keep],
              num_cols=full.n)
    wfn, dtype, want_scale = MINPLUS_WEIGHTS[name]
    w = None if wfn is None else wfn(np.random.default_rng(8),
                                     g.nnz).astype(np.float32)
    args = (g.rowptr, g.colidx, w)
    t = tbsr.build_hybrid(*args, num_cols=g.n, dense_threshold=2)
    j = jbsr.build_hybrid(*args, num_cols=g.n, dense_threshold=2)
    assert t.dense and t.rem.buckets and t.scale == want_scale
    assert all(p.panel.dtype == dtype for p in t.dense)
    assert (t.rem.buckets[0].vals is None) == (w is None or
                                               want_scale != 1.0)
    if scale is not None:
        t, j = dataclasses.replace(t, scale=scale), j._replace(scale=scale)
    return g, t, j


def _distances(n, seed=6):
    """Frontier distances: most vertices INF, the rest below 10^6."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 10 ** 6, n).astype(np.int32)
    x[rng.random(n) < 0.6] = INF
    return x


@pytest.mark.parametrize("scale", [None, 7.0])
@pytest.mark.parametrize("name", sorted(MINPLUS_WEIGHTS))
def test_spmv_hybrid_min_plus_matches_jax(name, scale):
    """Panels of every dtype, scale 1 and > 1, the weighted and the
    factored-uniform remainder, rows with no neighbours: exact."""
    g, t, j = _minplus_layouts(name, scale)
    x = _distances(g.n)
    before = tminsel.MINPLUS_LAUNCHES
    y_t = tbsr.spmv_hybrid_min_plus(t, torch.from_numpy(x), num_rows=g.m,
                                    sentinel=INF).numpy()
    y_j = np.asarray(jax.jit(functools.partial(
        jbsr.spmv_hybrid_min_plus, num_rows=g.m, sentinel=INF))(
            j, jnp.asarray(x)))
    np.testing.assert_array_equal(y_t, y_j)
    assert tminsel.MINPLUS_LAUNCHES == before    # CPU tensors: plain version
    assert (y_t == INF).any() and (y_t < INF).any()
    # no in-neighbour at all: the sentinel
    empty = np.diff(g.rowptr) == 0
    assert (y_t[:len(empty)][empty] == INF).all()


@pytest.mark.parametrize("name", ["int8", "bf16", "f32"])
def test_minplus_plain_matches_a_loop(name):
    """dense_panel_minplus_plain, panel array by panel array, against a
    loop over the nonzero cells, with scale 5 and the operand's pad slots
    at the sentinel."""
    g, t, _ = _minplus_layouts(name)
    qx = (g.n + 127) // 128
    x2d = np.full(qx * 128, INF, np.int64)
    x2d[:g.n] = _distances(g.n, seed=2)
    for p in t.dense:
        y = tminsel.dense_panel_minplus(
            p.panel, p.src, torch.from_numpy(x2d.astype(np.int32)).view(
                qx, 128), INF, 5).numpy()
        cells = p.panel.float().numpy()
        src = p.src.numpy()
        for r in range(0, src.shape[0], 7):
            cols = (src[r][:, None] * 128 + np.arange(128)).reshape(-1)
            for i in range(0, 128, 5):
                nz = np.flatnonzero(cells[r, i])
                cand = x2d[cols[nz]] + cells[r, i, nz].astype(np.int64) * 5
                assert y[r, i] == min([INF, *cand])


def test_minplus_plain_steps_clamp_and_the_widest_weights(monkeypatch):
    """Steps of any size give the same rows; a row whose every candidate
    passes the sentinel gets the sentinel; the widest weight each panel
    dtype holds (int8 127, bf16 256, f32 2^24) adds exactly; int32 wraps
    as an int32 add does."""
    rng = np.random.default_rng(1)
    src = torch.from_numpy(rng.integers(0, 4, (6, 2)).astype(np.int32))
    x2d = torch.from_numpy(rng.integers(0, 1000, (4, 128)).astype(np.int32))
    for dtype, top in ((torch.int8, 127), (torch.bfloat16, 256),
                       (torch.float32, 1 << 24)):
        panel = torch.zeros((6, 128, 256), dtype=dtype)
        panel[rng.random((6, 128, 256)) < 0.05] = top
        whole = tminsel.dense_panel_minplus_plain(panel, src, x2d, INF, 3)
        xg = x2d[src.long()].reshape(6, 1, 256).long()
        want = torch.where(panel != 0, xg + top * 3, INF).amin(2).clamp(
            max=INF)
        assert torch.equal(whole.long(), want)
        monkeypatch.setattr(tminsel, "PLAIN_STEP_CELLS", 1)
        assert torch.equal(
            tminsel.dense_panel_minplus_plain(panel, src, x2d, INF, 3), whole)
        monkeypatch.undo()
    full = torch.ones((1, 128, 128), dtype=torch.int8)
    one = torch.zeros((1, 1), dtype=torch.int32)
    y = tminsel.dense_panel_minplus_plain(
        full, one, torch.full((1, 128), INF, dtype=torch.int32), INF, 1)
    assert (y == INF).all()
    big = torch.full((1, 128), 2 ** 31 - 2, dtype=torch.int32)
    y = tminsel.dense_panel_minplus_plain(full, one, big, 2 ** 31 - 1, 4)
    assert (y == -(2 ** 31) + 2).all()           # (2^31 - 2) + 4 wraps


def test_minplus_wrapper_checks():
    _, t, _ = _minplus_layouts("int8")
    p = t.dense[0]
    x2d = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="scale"):
        tminsel.dense_panel_minplus(p.panel, p.src, x2d, INF, 1.5)
    with pytest.raises(TypeError):
        tminsel.dense_panel_minplus(p.panel, p.src, x2d.float(), INF)
    with pytest.raises(ValueError):
        tminsel.dense_panel_minplus(p.panel[:, :64], p.src, x2d, INF)
    with pytest.raises(AssertionError, match="integral"):
        tbsr.spmv_hybrid_min_plus(dataclasses.replace(t, scale=0.5),
                                  torch.zeros(900, dtype=torch.int32),
                                  num_rows=900, sentinel=INF)
