"""The rest of the port's multi-device layer (gardenia_tpu_torch.parallel:
CC, SSSP, SpMV, SymGS, BC, MST, SGD, and the 2D mesh's TC, SCC and VC)
against the JAX package's on the CPU: the solvers on gloo groups of 1, 2
and 4 CPU ranks (one spawn a group for the whole file), held to
gardenia_tpu.parallel's *_dist on the 8 virtual CPU devices of
tests/conftest.py (make_mesh2d for the 2D solvers), to the serial oracles
and, at one rank, to the port's single-device solvers; the rank-local
weighted shards and the 2D panels, in process, equal to the JAX
package's partitions.  Tolerances as the JAX dryrun states them: integer
results exact, SpMV rtol 2e-5 / atol 1e-6, BC atol 1e-5, SymGS rtol 1e-4
/ atol 1e-5, SGD rtol 2e-5 / atol 1e-7."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (conftest has set the 8 CPU devices)

from gardenia_tpu import parallel as JD
from gardenia_tpu.core.generate import generate_graph as jax_generate
from gardenia_tpu.core.graph import Graph as JGraph
from gardenia_tpu.core.relabel import relabeled as jax_relabeled
from gardenia_tpu.parallel import partition as JP
from gardenia_tpu.parallel import two_d as J2
from gardenia_tpu.solvers.vc import vc_solver as jax_vc
from gardenia_tpu.verify import oracles

from gardenia_tpu_torch import parallel as TD
from gardenia_tpu_torch.cli import same_components
from gardenia_tpu_torch.core.graph import from_csr_of
from gardenia_tpu_torch.parallel import call_each, run_on_ranks
from gardenia_tpu_torch.parallel import partition as TP
from gardenia_tpu_torch.parallel import two_d as T2
from gardenia_tpu_torch.parallel.mesh import mesh2d_shape

from tests.conftest import random_graph

BC_SOURCES = np.arange(8)
SGD_ITERS = 2


def _hashed(gj, top: int):
    """gj with the dryrun's hashed weights, 1..top, one a vertex pair."""
    src = np.repeat(np.arange(gj.m), np.diff(gj.rowptr))
    dst = np.asarray(gj.colidx)
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    w = ((lo * 2654435761 + hi * 40503) % top + 1).astype(np.float32)
    return JGraph(gj.rowptr, gj.colidx, w, num_cols=gj.n, symmetric=True)


def _inputs(gj):
    """The SymGS inputs of the JAX dryrun (seed 7) and a colouring."""
    rng = np.random.default_rng(7)
    return (rng.random(gj.nnz).astype(np.float32),
            rng.random(gj.m).astype(np.float32),
            rng.random(gj.m).astype(np.float32),
            (gj.degrees + 1).astype(np.float32),
            np.asarray(jax_vc(gj).colors))


def _spmv_inputs(gj):
    rng = np.random.default_rng(9)
    return (rng.random(gj.nnz).astype(np.float32),
            rng.random(gj.n).astype(np.float32),
            rng.random(gj.m).astype(np.float32))


@pytest.fixture(scope="module")
def graphs():
    """{name: (JAX package Graph, port Graph on the same arrays)}: the JAX
    dryrun's graph (R-MAT-10, degree 8, symmetrized), a directed random
    graph with unreachable vertices, a sparse symmetric one of many
    components, and R-MAT-10 with hashed weights 1..64 (int8 panels) and
    1..1000 (f32 panels)."""
    rmat = jax_generate("rmat", scale=10, degree=8, symmetrize=True,
                        need_reverse=True)
    out = {}
    for name, gj in (("rmat10", rmat),
                     ("directed", random_graph(m=150, avg_deg=2, seed=4)),
                     ("sparse", random_graph(m=300, avg_deg=1, seed=5,
                                             symmetric=True)),
                     ("w64", _hashed(rmat, 64)),
                     ("w1000", _hashed(rmat, 1000))):
        out[name] = (gj, from_csr_of(gj))
    return out


# (case, port solver, JAX solver or None, graph, args of the graphs, kwargs)
CASES = [
    ("cc hybrid rmat10", TD.cc_solver_dist, JD.cc_solver_dist, "rmat10",
     None, {}),
    ("cc ell rmat10", TD.cc_solver_dist, JD.cc_solver_dist, "rmat10", None,
     {"layout": "ell"}),
    ("cc hybrid sparse", TD.cc_solver_dist, JD.cc_solver_dist, "sparse",
     None, {}),
    ("cc ell sparse", TD.cc_solver_dist, JD.cc_solver_dist, "sparse", None,
     {"layout": "ell", "balance": "vertices"}),
    ("sssp hybrid rmat10", TD.sssp_solver_dist, JD.sssp_solver_dist,
     "rmat10", (0,), {}),
    ("sssp ell rmat10", TD.sssp_solver_dist, JD.sssp_solver_dist, "rmat10",
     (0,), {"layout": "ell"}),
    ("sssp hybrid directed", TD.sssp_solver_dist, JD.sssp_solver_dist,
     "directed", (3,), {}),
    ("sssp ell directed", TD.sssp_solver_dist, JD.sssp_solver_dist,
     "directed", (3,), {"layout": "ell", "balance": "vertices"}),
    ("sssp hybrid w64", TD.sssp_solver_dist, JD.sssp_solver_dist, "w64",
     (5,), {}),
    ("sssp ell w64", TD.sssp_solver_dist, JD.sssp_solver_dist, "w64", (5,),
     {"layout": "ell"}),
    ("sssp hybrid w1000", TD.sssp_solver_dist, JD.sssp_solver_dist,
     "w1000", (0,), {}),
    ("spmv hybrid rmat10", TD.spmv_solver_dist, JD.spmv_solver_dist,
     "rmat10", None, {}),
    ("spmv ell rmat10", TD.spmv_solver_dist, JD.spmv_solver_dist, "rmat10",
     None, {"layout": "ell"}),
    ("spmv hybrid directed", TD.spmv_solver_dist, JD.spmv_solver_dist,
     "directed", _spmv_inputs, {}),
    ("spmv ell directed", TD.spmv_solver_dist, JD.spmv_solver_dist,
     "directed", _spmv_inputs, {"layout": "ell", "balance": "vertices"}),
    ("symgs rmat10", TD.symgs_solver_dist, JD.symgs_solver_dist, "rmat10",
     _inputs, {}),
    # the single-device solver's default inputs (default_rng(13), the port's
    # colouring): held to the port's symgs_solver, not to JAX's
    ("symgs defaults rmat10", TD.symgs_solver_dist, None, "rmat10", None,
     {}),
    ("bc hybrid rmat10", TD.bc_batched_dist, JD.bc_batched_dist, "rmat10",
     (BC_SOURCES,), {"layout": "hybrid"}),
    ("bc coo rmat10", TD.bc_batched_dist, JD.bc_batched_dist, "rmat10",
     (BC_SOURCES,), {"layout": "coo"}),
    ("mst w64", TD.mst_solver_dist, JD.mst_solver_dist, "w64", None, {}),
    ("mst rmat10", TD.mst_solver_dist, JD.mst_solver_dist, "rmat10", None,
     {"balance": "vertices"}),
    ("sgd rmat10", TD.sgd_train_dist, JD.sgd_train_dist, "rmat10", None,
     {"iters": SGD_ITERS}),
    ("tc2d rmat10", TD.tc_solver_dist2d, J2.tc_solver_dist2d, "rmat10",
     None, {}),
    ("scc2d directed", TD.scc_solver_dist2d, J2.scc_solver_dist2d,
     "directed", None, {}),
    ("scc2d rmat10", TD.scc_solver_dist2d, J2.scc_solver_dist2d, "rmat10",
     None, {}),
    ("vc2d rmat10", TD.vc_solver_dist2d, J2.vc_solver_dist2d, "rmat10",
     None, {}),
]
NAMES = [c[0] for c in CASES]


def _of(prefix):
    return [c for c in NAMES if c.startswith(prefix)]


@pytest.fixture(scope="module")
def cases(graphs):
    """{case: (case, port solver, JAX solver, graph, args, kwargs)}, the
    args made from the case's graph."""
    out = {}
    for name, fn, jfn, gname, args, kw in CASES:
        if callable(args):
            args = args(graphs[gname][0])
        out[name] = (name, fn, jfn, gname, args or (), kw)
    return out


@pytest.fixture(scope="module")
def port_runs(graphs, cases):
    """n -> {case: port result}, one gloo group of n CPU ranks a size."""
    cache = {}

    def get(n):
        if n not in cache:
            calls = [(fn, (graphs[gname][1], *args), kw)
                     for _, fn, _, gname, args, kw in cases.values()]
            cache[n] = dict(zip(cases, run_on_ranks(call_each, n, "cpu",
                                                    calls)[0]))
        return cache[n]
    return get


@pytest.fixture(scope="module")
def jax_runs(graphs, cases):
    """n -> {case: the JAX package's result on an n-device mesh}."""
    cache = {}

    def get(n):
        if n not in cache:
            mesh, mesh2d = JD.make_mesh(n), J2.make_mesh2d(n)
            cache[n] = {
                name: jfn(graphs[gname][0], *args,
                          mesh=mesh2d if "2d" in name else mesh, **kw)
                for name, _, jfn, gname, args, kw in cases.values()
                if jfn is not None}
        return cache[n]
    return get


# ---- the solvers against the JAX package's and the oracles ----------------

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", _of("cc "))
def test_cc_dist_matches_jax_and_oracle(graphs, cases, port_runs, jax_runs,
                                        n, name):
    got, want = port_runs(n)[name], jax_runs(n)[name]
    comp = got.comp.numpy()
    np.testing.assert_array_equal(comp, np.asarray(want.comp))
    assert got.iterations == int(want.iterations)
    gj = graphs[cases[name][3]][0]
    assert same_components(comp, oracles.cc_serial(gj))
    # every label is its component's least id
    assert (comp <= np.arange(gj.m)).all()


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", _of("sssp "))
def test_sssp_dist_matches_jax_and_oracle(graphs, cases, port_runs,
                                          jax_runs, n, name):
    _, _, _, gname, (src,), _ = cases[name]
    got, want = port_runs(n)[name], jax_runs(n)[name]
    dist = got.dist.numpy()
    assert dist.dtype == np.int32
    np.testing.assert_array_equal(dist, np.asarray(want.dist))
    np.testing.assert_array_equal(dist, oracles.sssp_serial(
        graphs[gname][0], src))
    assert got.iterations == int(want.iterations)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", _of("spmv "))
def test_spmv_dist_matches_jax_and_oracle(graphs, cases, port_runs,
                                          jax_runs, n, name):
    _, _, _, gname, args, _ = cases[name]
    gj = graphs[gname][0]
    got = port_runs(n)[name].numpy()
    np.testing.assert_allclose(got, np.asarray(jax_runs(n)[name]),
                               rtol=2e-5, atol=1e-6)
    ax, x, y = args or (np.full(gj.nnz, 0.2, np.float32),
                        np.full(gj.n, 0.3, np.float32), 0.0)
    np.testing.assert_allclose(got, oracles.spmv_serial(gj, ax, x) + y,
                               rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_symgs_dist_matches_jax(port_runs, jax_runs, n):
    got, want = port_runs(n)["symgs rmat10"], jax_runs(n)["symgs rmat10"]
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-4,
                               atol=1e-5)
    assert got.num_colors == int(want.num_colors)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_symgs_dist_defaults_match_single_device(graphs, port_runs, n):
    from gardenia_tpu_torch.solvers.symgs import symgs_solver
    got = port_runs(n)["symgs defaults rmat10"]
    want = symgs_solver(graphs["rmat10"][1], device="cpu")
    np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=1e-4,
                               atol=1e-5)
    assert got.num_colors == want.num_colors


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", _of("bc "))
def test_bc_dist_matches_jax(port_runs, jax_runs, n, name):
    got, want = port_runs(n)[name], jax_runs(n)[name]
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               atol=1e-5, rtol=0)
    assert got.iterations == int(want.iterations)
    assert float(got.scores.max()) == 1.0


def test_bc_dist_needs_the_mesh_to_divide_the_sources(graphs):
    gj, gt = graphs["rmat10"]
    with pytest.raises(ValueError, match="must divide"):
        JD.bc_batched_dist(gj, np.arange(5), mesh=JD.make_mesh(2))
    # raised before any collective: a rank's view of a 2-rank group
    mesh = SimpleNamespace(size=2, rank=0, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="must divide"):
        TD.bc_batched_dist(gt, np.arange(5), mesh=mesh)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", _of("mst "))
def test_mst_dist_matches_jax_and_oracle(graphs, cases, port_runs, jax_runs,
                                         n, name):
    got, want = port_runs(n)[name], jax_runs(n)[name]
    assert got.total_weight == float(want.total_weight)
    np.testing.assert_array_equal(got.edge_mask.numpy(),
                                  np.asarray(want.edge_mask))
    np.testing.assert_array_equal(got.comp.numpy(), np.asarray(want.comp))
    gj = graphs[cases[name][3]][0]
    assert got.total_weight == oracles.mst_total_weight(gj)


@pytest.mark.parametrize("n", [2, 4])
def test_sgd_dist_matches_jax(port_runs, jax_runs, n):
    got, want = port_runs(n)["sgd rmat10"], jax_runs(n)["sgd rmat10"]
    for a, b in ((got.user_lv, want.user_lv), (got.item_lv, want.item_lv),
                 (got.rmse, want.rmse)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("n", [2, 4])
def test_tc2d_matches_jax_and_oracle(graphs, port_runs, jax_runs, n):
    got = port_runs(n)["tc2d rmat10"]
    assert got == jax_runs(n)["tc2d rmat10"]
    assert got == oracles.tc_serial(graphs["rmat10"][0].oriented())


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", _of("scc2d "))
def test_scc2d_matches_jax_and_oracle(graphs, cases, port_runs, jax_runs,
                                      n, name):
    got, want = port_runs(n)[name], jax_runs(n)[name]
    root = got.scc_root.numpy()
    np.testing.assert_array_equal(root, np.asarray(want.scc_root))
    assert got.iterations == int(want.iterations)
    assert same_components(root, oracles.scc_serial(
        graphs[cases[name][3]][0]))


@pytest.mark.parametrize("n", [2, 4])
def test_vc2d_colours_equal_jax(graphs, port_runs, jax_runs, n):
    got, want = port_runs(n)["vc2d rmat10"], jax_runs(n)["vc2d rmat10"]
    colors = got.colors.numpy()
    assert oracles.vc_check(graphs["rmat10"][0], colors)
    np.testing.assert_array_equal(colors, np.asarray(want.colors))
    assert (got.num_colors, got.iterations) == \
        (int(want.num_colors), int(want.iterations))


# ---- one rank: the port's single-device solvers ---------------------------

@pytest.mark.parametrize("name", [c for c in NAMES if "defaults" not in c])
def test_dist_on_one_rank_equals_single_device(graphs, cases, port_runs,
                                               name):
    from gardenia_tpu_torch.solvers import (bc, cc, mst, scc, sgd, spmv,
                                            sssp, symgs, tc)
    got = port_runs(1)[name]
    _, _, _, gname, args, kw = cases[name]
    gj, g = graphs[gname]
    kernel = name.split()[0]
    if kernel == "cc":
        want = cc.cc_sv(g, device="cpu").comp.numpy()
        assert same_components(got.comp.numpy(), want)
    elif kernel == "sssp":
        want = sssp.sssp_solver(g, args[0], device="cpu")
        assert torch.equal(got.dist, want.dist)
    elif kernel == "spmv":
        want = spmv.spmv_solver(g, *args, device="cpu")
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5,
                                   atol=1e-6)
    elif kernel == "symgs":
        want = symgs.symgs_solver(g, *args, device="cpu")
        np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), rtol=1e-4,
                                   atol=1e-5)
    elif kernel == "bc":
        want = bc.bc_batched(g, *args, layout={"coo": "ell"}.get(
            kw["layout"], kw["layout"]), device="cpu")
        np.testing.assert_allclose(got.scores.numpy(), want.scores.numpy(),
                                   atol=1e-5, rtol=0)
        assert got.iterations == want.iterations
    elif kernel == "mst":
        assert got.total_weight == mst.mst_solver(g, device="cpu") \
            .total_weight
    elif kernel == "sgd":
        want = sgd.sgd_solver(g, max_iters=SGD_ITERS, epsilon=0.0,
                              batches=0, device="cpu")
        for a, b in ((got.user_lv, want.user_lv),
                     (got.item_lv, want.item_lv),
                     (got.rmse, want.rmse[SGD_ITERS - 1])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                       atol=1e-7)
    elif kernel == "tc2d":
        assert got == tc.tc_solver(g, device="cpu")
    elif kernel == "scc2d":
        want = scc.scc_solver(g, device="cpu").scc_root.numpy()
        assert same_components(got.scc_root.numpy(), want)
    else:
        # the single-device VC ends with a sequential core pass and may
        # stop sooner: one rank of the speculative rounds is the JAX
        # package's one-device run, exactly
        want = J2.vc_solver_dist2d(gj, mesh=J2.make_mesh2d(1))
        np.testing.assert_array_equal(got.colors.numpy(),
                                      np.asarray(want.colors))


# ---- the partitions, in process: equal to the JAX package's ---------------

@pytest.mark.parametrize("n", range(1, 9))
def test_mesh2d_shape_is_the_jax_packages(n):
    assert mesh2d_shape(n) == J2.make_mesh2d(n).devices.shape


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 3)])
@pytest.mark.parametrize("gname", ["rmat10", "directed"])
def test_partition_edges_2d_matches_jax(graphs, shape, gname):
    """The stacked panels equal JAX's, and each rank's panel_edges is its
    slice of them without the padding."""
    gj, gt = graphs[gname]
    r, c = shape
    ej, et = J2.partition_edges_2d(gj, r, c), T2.partition_edges_2d(gt, r, c)
    assert (et.rows_per, et.cols_per) == (ej.rows_per, ej.cols_per)
    np.testing.assert_array_equal(et.src, np.asarray(ej.src))
    np.testing.assert_array_equal(et.dst, np.asarray(ej.dst))
    for i in range(r):
        for k in range(c):
            mesh = SimpleNamespace(shape=shape, coords=(i, k),
                                   device=torch.device("cpu"))
            src, dst = T2.panel_edges(gt, mesh)
            real = et.src[i, k] < gt.m
            np.testing.assert_array_equal(src.numpy(), et.src[i, k][real])
            np.testing.assert_array_equal(dst.numpy(), et.dst[i, k][real])


@pytest.fixture(scope="module")
def relabelled_weighted():
    """(JAX, port) Graphs of a degree-relabelled weighted R-MAT-10."""
    gj = jax_relabeled(jax_generate("rmat", scale=10, degree=8,
                                    symmetrize=True, weighted=True)).graph
    return gj, from_csr_of(gj)


def _ax(kind, gj, n):
    """Edge values of each kind: by the graph's weights; one uniform
    value (factored out); constant within each shard but not across them
    (factoring off); and shards whose cells need int8, bf16 and f32 by
    turns (the common dtype is the widest)."""
    if kind == "weighted":
        return {"weighted": True}
    if kind == "uniform ax":
        return {"ax": np.full(gj.nnz, 0.2, np.float32)}
    bounds = JP.edge_balanced_bounds(gj.rowptr, n)
    shard = np.searchsorted(bounds, np.repeat(
        np.arange(gj.m), np.diff(gj.rowptr)), side="right") - 1
    if kind == "ax by shard":
        return {"ax": (shard + 2).astype(np.float32)}
    rng = np.random.default_rng(3)
    top = np.array([100, 200, 300, 0])[shard % 4]
    ax = rng.integers(1, 10, gj.nnz) + np.where(
        rng.random(gj.nnz) < 0.01, top, 0)
    return {"ax": ax.astype(np.float32), "reverse": True}


@pytest.mark.parametrize("kind", ["weighted", "uniform ax", "ax by shard",
                                  "mixed dtypes"])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_weighted_rank_shard_is_its_slice_of_jax_stacked(
        relabelled_weighted, n, kind):
    """hybrid_shard with weights, as one rank builds it alone, equals its
    slice of the JAX package's partition_hybrid_stacked: the scale, the
    common panel dtype, panels, block tables and block rows (the stacked
    form pads R with zero panels), and the weighted ELL remainder."""
    gj, gt = relabelled_weighted
    kw = _ax(kind, gj, n)
    sj = JP.partition_hybrid_stacked(gj, n, **kw)
    mb = sj.rows_per_shard
    dts = set()
    for s in range(n):
        sh = TP.hybrid_shard(gt, n, s, **kw)
        assert sh.mat.scale == sj.hyb.scale
        assert sh.ranges.rows_per_shard == mb
        mine = {p.width: p for p in sh.mat.dense}
        for pj in sj.hyb.dense:
            p = mine.pop(pj.width, None)
            R = 0 if p is None else p.panel.shape[0]
            panel = np.asarray(pj.panel[s])
            assert not panel[R:].astype(np.float32).any()
            if p is None:
                continue
            dts.add(p.panel.dtype)
            assert str(p.panel.dtype).split(".")[-1] == str(panel.dtype)
            np.testing.assert_array_equal(p.panel.float().numpy(),
                                          panel[:R].astype(np.float32))
            np.testing.assert_array_equal(p.src.numpy(),
                                          np.asarray(pj.src[s])[:R])
            np.testing.assert_array_equal(p.rows.numpy(),
                                          np.asarray(pj.rows[s])[:R])
        assert not mine
        widths = {b.cols.shape[0]: b for b in sh.mat.rem.buckets}
        for bj in sj.hyb.rem.buckets:
            rids = np.asarray(bj.row_ids[s])
            real = rids != mb
            b = widths.get(bj.cols.shape[1])
            if b is None:
                assert not real.any()
                continue
            keep = b.row_ids.numpy() != mb
            np.testing.assert_array_equal(b.row_ids.numpy()[keep],
                                          rids[real])
            np.testing.assert_array_equal(b.cols.numpy()[:, keep],
                                          np.asarray(bj.cols[s])[:, real])
            if bj.vals is not None and b.vals is not None:
                np.testing.assert_array_equal(
                    b.vals.numpy()[:, keep], np.asarray(bj.vals[s])[:, real])
    if kind == "mixed dtypes" and n > 2:
        assert dts == {torch.float32}


def test_stacked_plan_takes_the_widest_shard():
    """The plan's dtype is the widest shard's, found without building the
    panels: the hub row's cells of 200 make every shard bf16, of 300 f32,
    as the stacked form has it."""
    gj = jax_relabeled(jax_generate("rmat", scale=9, degree=8,
                                    symmetrize=True)).graph
    gt = from_csr_of(gj)
    rp, ci = gj.rowptr, gj.colidx
    bounds = TP.edge_balanced_bounds(rp, 2)
    mb = TP._hybrid_mb(bounds)
    for top, want in ((0, torch.int8), (200, torch.bfloat16),
                      (300, torch.float32)):
        w = np.random.default_rng(2).integers(1, 10, gj.nnz) \
            .astype(np.float32)
        w[rp[0]:rp[1]] += top           # the hub's row: its dense blocks
        assert TP.stacked_plan(rp, ci, w, bounds, mb, 16) == (True, want)
        stacked = TP.partition_hybrid_stacked(gt, 2, ax=w)
        assert {p.panel.dtype for p in stacked.hyb.dense} == {want}
        shards = [TP.hybrid_shard(gt, 2, s, ax=w) for s in (0, 1)]
        assert {p.panel.dtype for sh in shards for p in sh.mat.dense} == \
            {want}
